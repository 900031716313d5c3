"""Command registry — data-driven CLI surface.

Ref: src/ngsep/main/CommandsDescriptor.xml (1911 lines, 44 commands in 5
groups) + CommandsDescriptor.java:431-475 (reflective `-x value` ->
setter mapping) + NGSEPcore.java:35-67 (dispatch, legacy-id redirect).

The XML registry becomes a Python dict; the reflective setter injection
becomes typed Option descriptors applied to engine constructor kwargs.
Command ids and flags keep the reference's names so existing NGSEP
invocations translate directly.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable


@dataclass
class Option:
    flag: str  # e.g. "k"
    attr: str  # engine kwarg name
    type: str = "str"  # str|int|float|bool (bool = presence flag)
    default: object = None
    help: str = ""


@dataclass
class Command:
    id: str
    runner: Callable  # (options dict, positional args, torch device)
    description: str
    group: str
    options: list[Option] = field(default_factory=list)
    former_id: str | None = None
    hidden: bool = False


_REGISTRY: dict[str, Command] = {}
_FORMER: dict[str, str] = {}


def register(cmd: Command) -> None:
    _REGISTRY[cmd.id] = cmd
    if cmd.former_id:
        _FORMER[cmd.former_id] = cmd.id


def get_command(cmd_id: str) -> Command | None:
    if cmd_id in _REGISTRY:
        return _REGISTRY[cmd_id]
    if cmd_id in _FORMER:
        return _REGISTRY[_FORMER[cmd_id]]
    return None


def all_commands() -> list[Command]:
    return list(_REGISTRY.values())


def parse_args(cmd: Command, argv: list[str]) -> tuple[dict, list[str]]:
    """Map `-x value` flags to typed option values (ref: loadOptions)."""
    opts = {o.flag: o for o in cmd.options}
    values: dict = {}
    positional: list[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("-") and len(a) > 1 and not a[1].isdigit():
            flag = a.lstrip("-")
            o = opts.get(flag)
            if o is None:
                raise SystemExit(f"Unrecognized option -{flag} for command {cmd.id}")
            if o.type == "bool":
                values[o.attr] = True
            else:
                i += 1
                if i >= len(argv):
                    raise SystemExit(f"Option -{flag} requires a value")
                raw = argv[i]
                if o.type == "int":
                    values[o.attr] = int(raw)
                elif o.type == "float":
                    values[o.attr] = float(raw)
                else:
                    values[o.attr] = raw
        else:
            positional.append(a)
        i += 1
    return values, positional
