"""BAM binary I/O: BGZF block compression + BAM record codec.

Ref: the reference delegates BAM to htsjdk (ReadAlignmentFileReader.java:35-43,
ReadAlignmentFileWriter.java:26-34 — its only third-party alignment
dependency).  This module implements the SAMv1/BAM spec directly so the
framework stays dependency-free: BGZF is gzip with fixed-size member blocks
carrying a BC extra subfield (BSIZE), which lets standard tools seek; BAM
records are little-endian structs with 4-bit packed bases.

Reading uses Python's zlib/gzip multi-member support (BGZF is valid
concatenated gzip); writing emits true BGZF blocks + the standard EOF
marker so samtools/htsjdk can consume the output.
"""
from __future__ import annotations

import gzip
import struct
import zlib
from typing import Iterator

from ..align.read_alignment import ReadAlignment
from ..core.sequences import QualifiedSequenceList

BGZF_BLOCK = 65280  # uncompressed payload per block
# 28-byte empty BGZF block marking EOF (SAMv1 spec §4.1.2)
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_CIGAR_OPS = "MIDNSHP=X"
_SEQ_CODES = "=ACMGRSVTWYHKDBN"
_SEQ_LOOKUP = {c: i for i, c in enumerate(_SEQ_CODES)}


def _bgzf_block(payload: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = co.compress(payload) + co.flush()
    bsize = len(comp) + 25 + 1  # header(12)+XLEN extra(6)+deflate+crc(4)+isize(4)
    header = struct.pack(
        "<BBBBIBBHBBHH",
        0x1F, 0x8B, 8, 4,  # gzip magic, deflate, FEXTRA
        0, 0, 0xFF,  # mtime, xfl, os
        6,  # xlen
        0x42, 0x43, 2,  # 'B','C', subfield length
        bsize - 1,
    )
    return header + comp + struct.pack("<II", zlib.crc32(payload), len(payload) & 0xFFFFFFFF)


class BGZFWriter:
    def __init__(self, path: str):
        self.fh = open(path, "wb")
        self.buf = bytearray()
        self.coffset = 0  # compressed bytes flushed so far

    def tell_virtual(self) -> int:
        """BGZF virtual offset of the next byte written:
        (compressed block offset << 16) | offset within the block."""
        return (self.coffset << 16) | len(self.buf)

    def write(self, data: bytes) -> None:
        self.buf += data
        while len(self.buf) >= BGZF_BLOCK:
            blk = _bgzf_block(bytes(self.buf[:BGZF_BLOCK]))
            self.fh.write(blk)
            self.coffset += len(blk)
            del self.buf[:BGZF_BLOCK]

    def close(self) -> None:
        if self.buf:
            blk = _bgzf_block(bytes(self.buf))
            self.fh.write(blk)
            self.coffset += len(blk)
            self.buf.clear()
        self.fh.write(BGZF_EOF)
        self.fh.close()


def encode_bam_record(aln: ReadAlignment, ref_ids: dict[str, int]) -> bytes:
    name = (aln.read_name or "*").encode()
    ref_id = ref_ids.get(aln.sequence_name, -1) if aln.sequence_name else -1
    pos = aln.first - 1 if aln.sequence_name else -1
    mate_ref = (
        ref_ids.get(aln.mate_sequence_name, -1) if aln.mate_sequence_name else -1
    )
    mate_pos = aln.mate_first - 1 if aln.mate_first else -1
    cigar = aln.cigar if aln.sequence_name else []
    seq = aln.read_chars or ""
    qual = aln.qualities or ""
    l_seq = len(seq)
    packed = bytearray((l_seq + 1) // 2)
    for i, ch in enumerate(seq):
        code = _SEQ_LOOKUP.get(ch.upper(), 15)
        if i % 2 == 0:
            packed[i // 2] = code << 4
        else:
            packed[i // 2] |= code
    quals = bytes((min(93, ord(q) - 33) for q in qual)) if qual else b"\xff" * l_seq
    cig = b"".join(
        struct.pack("<I", (l << 4) | _CIGAR_OPS.index(op)) for l, op in cigar
    )
    tags = b"NMC" + struct.pack("<B", min(255, max(0, aln.num_mismatches)))
    if aln.read_group:
        tags += b"RGZ" + aln.read_group.encode() + b"\x00"
    body = (
        struct.pack(
            "<iiBBHHHiiii",
            ref_id,
            pos,
            len(name) + 1,
            aln.alignment_quality & 0xFF,
            _reg2bin(pos, pos + max(1, sum(l for l, op in cigar if op in "MDN=X"))),
            len(cigar),
            aln.flags,
            l_seq,
            mate_ref,
            mate_pos,
            aln.inferred_insert_size,
        )
        + name
        + b"\x00"
        + cig
        + bytes(packed)
        + quals
        + tags
    )
    return struct.pack("<I", len(body)) + body


def _reg2bin(beg: int, end: int) -> int:
    """BAM bin from an alignment interval (SAMv1 spec §5.3)."""
    end -= 1
    if beg < 0:
        return 4680
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


class BAMWriter:
    """BAM writer with the same interface as io.sam.ReadAlignmentFileWriter."""

    def __init__(
        self,
        sequences: QualifiedSequenceList,
        path: str,
        sample_id: str | None = None,
        platform: str = "ILLUMINA",
        sort_order: str = "unsorted",
    ):
        self.bgzf = BGZFWriter(path)
        self.sample_id = sample_id
        self.ref_ids = {s.name: i for i, s in enumerate(sequences)}
        text = f"@HD\tVN:1.6\tSO:{sort_order}\n"
        for s in sequences:
            text += f"@SQ\tSN:{s.name}\tLN:{len(s)}\n"
        if sample_id:
            text += f"@RG\tID:{sample_id}\tSM:{sample_id}\tPL:{platform}\n"
        text += "@PG\tID:ngsepcore_tpu_torch\tPN:ngsepcore_tpu_torch\n"
        t = text.encode()
        self.bgzf.write(b"BAM\x01" + struct.pack("<i", len(t)) + t)
        self.bgzf.write(struct.pack("<i", len(sequences)))
        for s in sequences:
            n = s.name.encode() + b"\x00"
            self.bgzf.write(struct.pack("<i", len(n)) + n + struct.pack("<i", len(s)))

    def write(self, aln: ReadAlignment) -> None:
        if self.sample_id and aln.read_group is None:
            aln.read_group = self.sample_id
        self.bgzf.write(encode_bam_record(aln, self.ref_ids))

    def close(self) -> None:
        self.bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


# ---------------------------------------------------------------------------
# BGZF block-level reading + a .bai-equivalent linear index.
#
# Ref: the reference restricts the caller to -querySeq/-first/-last through
# htsjdk's indexed BAM reads (AlignmentsPileupGenerator.java:310-321,
# ReadAlignmentFileReader.setLoadMode + query).  Here the index is the
# standard linear-index idea from SAMv1 §5.1.3: for every 16 kb genome
# window, the smallest BGZF virtual offset (compressed block offset << 16 |
# within-block offset) among records OVERLAPPING the window — region reads
# seek straight to that block and decode forward.  Stored as
# <bam>.lidx.npz (numpy container; same information as .bai's linear
# index, without the R-tree bins the pileup scan never needs).
# ---------------------------------------------------------------------------

LINEAR_SHIFT = 14  # 16 kb windows, same as .bai


def _iter_bgzf_blocks(fh):
    """Yield (compressed_offset, payload) for each BGZF block."""
    while True:
        coff = fh.tell()
        header = fh.read(18)
        if len(header) < 18:
            return
        if header[:2] != b"\x1f\x8b":
            raise ValueError("not a BGZF stream")
        xlen = struct.unpack_from("<H", header, 10)[0]
        extra = header[12:18] + fh.read(max(0, xlen - 6))
        bsize = None
        off = 0
        while off + 4 <= len(extra):
            si1, si2, slen = extra[off], extra[off + 1], struct.unpack_from("<H", extra, off + 2)[0]
            if si1 == 0x42 and si2 == 0x43 and slen == 2:
                bsize = struct.unpack_from("<H", extra, off + 4)[0] + 1
                break
            off += 4 + slen
        if bsize is None:
            raise ValueError("BGZF block without BSIZE (cannot seek)")
        rest = fh.read(bsize - 18 - (xlen - 6))
        comp = rest[: len(rest) - 8]
        payload = zlib.decompress(comp, -15)
        if payload:
            yield coff, payload


def build_bam_index(path: str, index_path: str | None = None) -> str:
    """Scan a BAM once and write the linear index.  Returns the index path."""
    import numpy as np

    index_path = index_path or path + ".lidx.npz"
    with open(path, "rb") as fh:
        blocks = _iter_bgzf_blocks(fh)
        cur = bytearray()
        starts: list[tuple[int, int]] = []  # (coff, within) per byte chunk
        chunk_bounds: list[int] = []

        def _pull(n: int) -> bool:
            while len(cur) < n:
                try:
                    coff, payload = next(blocks)
                except StopIteration:
                    return False
                starts.append((coff, 0))
                chunk_bounds.append(len(cur))
                cur.extend(payload)
            return True

        consumed = 0

        def _voffset_at(pos_in_cur: int) -> int:
            # map a position in the concatenated buffer to (coff, within)
            t = len(chunk_bounds) - 1
            while t > 0 and chunk_bounds[t] > pos_in_cur:
                t -= 1
            coff, _ = starts[t]
            return (coff << 16) | (pos_in_cur - chunk_bounds[t])

        def _consume(n: int) -> bytes:
            nonlocal consumed
            out = bytes(cur[:n])
            del cur[:n]
            shift = n
            # rebase chunk bookkeeping
            for t in range(len(chunk_bounds)):
                chunk_bounds[t] -= shift
            while len(chunk_bounds) > 1 and chunk_bounds[1] <= 0:
                chunk_bounds.pop(0)
                starts.pop(0)
            return out

        # header
        assert _pull(8)
        magic = _consume(4)
        if magic != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file")
        (l_text,) = struct.unpack("<i", _consume(4))
        _pull(l_text + 4)
        _consume(l_text)
        (n_ref,) = struct.unpack("<i", _consume(4))
        ref_lens = []
        for _ in range(n_ref):
            _pull(4)
            (l_name,) = struct.unpack("<i", _consume(4))
            _pull(l_name + 4)
            _consume(l_name)
            ref_lens.append(struct.unpack("<i", _consume(4))[0])
        linear = [
            np.full(max(1, (rl >> LINEAR_SHIFT) + 1), -1, np.int64)
            for rl in ref_lens
        ]
        while True:
            if not _pull(4):
                break
            voff = _voffset_at(0)
            (block_size,) = struct.unpack("<i", _consume(4))
            if not _pull(block_size):
                break
            body = _consume(block_size)
            ref_id, pos = struct.unpack_from("<ii", body, 0)
            if ref_id < 0 or pos < 0:
                continue
            n_cigar = struct.unpack_from("<H", body, 12)[0]
            l_read_name = body[8]
            span = 0
            off2 = 32 + l_read_name
            for t in range(n_cigar):
                (v,) = struct.unpack_from("<I", body, off2 + 4 * t)
                if _CIGAR_OPS[v & 0xF] in "MDN=X":
                    span += v >> 4
            end = pos + max(1, span)
            li = linear[ref_id]
            w0, w1 = pos >> LINEAR_SHIFT, (end - 1) >> LINEAR_SHIFT
            for w in range(w0, min(w1, len(li) - 1) + 1):
                if li[w] < 0 or voff < li[w]:
                    li[w] = voff
        # fill missing windows with the next known offset so lookups on
        # sparse coverage still land before the region
        for li in linear:
            nxt = -1
            for w in range(len(li) - 1, -1, -1):
                if li[w] < 0:
                    li[w] = nxt
                else:
                    nxt = li[w]
        np.savez(
            index_path,
            n_ref=np.int64(n_ref),
            **{f"lin{i}": li for i, li in enumerate(linear)},
        )
    return index_path


class BAMReader:
    """Iterates ReadAlignment records from a BAM file (filters like
    io.sam.ReadAlignmentFileReader)."""

    def __init__(
        self,
        path: str,
        min_mq: int = 0,
        skip_secondary: bool = True,
        skip_unmapped: bool = True,
    ):
        self.path = path
        self.min_mq = min_mq
        self.skip_secondary = skip_secondary
        self.skip_unmapped = skip_unmapped
        self.sequence_names: list[str] = []
        self.sequence_lengths: list[int] = []
        self.read_groups: dict[str, str] = {}

    def __iter__(self) -> Iterator[ReadAlignment]:
        with gzip.open(self.path, "rb") as fh:
            magic = fh.read(4)
            if magic != b"BAM\x01":
                raise ValueError(f"{self.path}: not a BAM file")
            (l_text,) = struct.unpack("<i", fh.read(4))
            text = fh.read(l_text).decode(errors="replace")
            for line in text.splitlines():
                if line.startswith("@RG"):
                    fields = dict(
                        f.split(":", 1) for f in line.split("\t")[1:] if ":" in f
                    )
                    self.read_groups[fields.get("ID", "")] = fields.get(
                        "SM", fields.get("ID", "")
                    )
            (n_ref,) = struct.unpack("<i", fh.read(4))
            for _ in range(n_ref):
                (l_name,) = struct.unpack("<i", fh.read(4))
                name = fh.read(l_name)[:-1].decode()
                (l_ref,) = struct.unpack("<i", fh.read(4))
                self.sequence_names.append(name)
                self.sequence_lengths.append(l_ref)
            while True:
                size_b = fh.read(4)
                if len(size_b) < 4:
                    break
                (block_size,) = struct.unpack("<i", size_b)
                body = fh.read(block_size)
                aln = self._decode(body)
                if aln is None:
                    continue
                if self.skip_unmapped and aln.is_unmapped:
                    continue
                if self.skip_secondary and aln.is_secondary:
                    continue
                if aln.alignment_quality < self.min_mq:
                    continue
                yield aln

    def _read_header_meta(self) -> str:
        """Populate sequence names/lengths/read groups; returns the @HD
        sort order ('coordinate' when the file is position-sorted)."""
        so = ""
        with gzip.open(self.path, "rb") as fh:
            if fh.read(4) != b"BAM\x01":
                raise ValueError(f"{self.path}: not a BAM file")
            (l_text,) = struct.unpack("<i", fh.read(4))
            text = fh.read(l_text).decode(errors="replace")
            for line in text.splitlines():
                if line.startswith("@HD") and "SO:" in line:
                    so = line.split("SO:")[1].split("\t")[0].strip()
                if line.startswith("@RG"):
                    fields = dict(
                        f.split(":", 1) for f in line.split("\t")[1:] if ":" in f
                    )
                    self.read_groups[fields.get("ID", "")] = fields.get(
                        "SM", fields.get("ID", "")
                    )
            (n_ref,) = struct.unpack("<i", fh.read(4))
            self.sequence_names = []
            self.sequence_lengths = []
            for _ in range(n_ref):
                (l_name,) = struct.unpack("<i", fh.read(4))
                self.sequence_names.append(fh.read(l_name)[:-1].decode())
                (l_ref,) = struct.unpack("<i", fh.read(4))
                self.sequence_lengths.append(l_ref)
        return so

    def iter_region(
        self, seq_name: str, first: int, last: int
    ) -> Iterator[ReadAlignment]:
        """Alignments overlapping [first, last] (1-based inclusive) of
        `seq_name`, via the linear index (built on first use) — the
        equivalent of htsjdk's indexed query behind the reference's
        -querySeq/-first/-last flags
        (AlignmentsPileupGenerator.java:310-321).  Falls back to a full
        filtered scan when the file is not coordinate-sorted."""
        import os

        import numpy as np

        so = self._read_header_meta()
        if seq_name not in self.sequence_names:
            return
        if so != "coordinate":
            for aln in self:
                if (
                    aln.sequence_name == seq_name
                    and aln.first <= last
                    and aln.last >= first
                ):
                    yield aln
            return
        ref_id = self.sequence_names.index(seq_name)
        idx_path = self.path + ".lidx.npz"
        if not os.path.exists(idx_path):
            build_bam_index(self.path, idx_path)
        idx = np.load(idx_path)
        li = idx[f"lin{ref_id}"]
        w = min(max(0, (first - 1) >> LINEAR_SHIFT), len(li) - 1)
        voff = int(li[w])
        if voff < 0:
            return
        coff, within = voff >> 16, voff & 0xFFFF
        with open(self.path, "rb") as fh:
            fh.seek(coff)
            blocks = _iter_bgzf_blocks(fh)
            cur = bytearray()

            def _pull(n: int) -> bool:
                while len(cur) < n:
                    try:
                        _, payload = next(blocks)
                    except StopIteration:
                        return False
                    cur.extend(payload)
                return True

            if not _pull(within):
                return
            del cur[:within]
            while True:
                if not _pull(4):
                    return
                (block_size,) = struct.unpack("<i", bytes(cur[:4]))
                del cur[:4]
                if not _pull(block_size):
                    return
                body = bytes(cur[:block_size])
                del cur[:block_size]
                rid, pos = struct.unpack_from("<ii", body, 0)
                if rid != ref_id:
                    if rid > ref_id or rid < 0:
                        return
                    continue
                if pos + 1 > last:
                    return  # coordinate-sorted: nothing later overlaps
                aln = self._decode(body)
                if aln is None:
                    continue
                if self.skip_unmapped and aln.is_unmapped:
                    continue
                if self.skip_secondary and aln.is_secondary:
                    continue
                if aln.alignment_quality < self.min_mq:
                    continue
                if aln.first <= last and aln.last >= first:
                    yield aln

    def _decode(self, body: bytes) -> ReadAlignment | None:
        (
            ref_id,
            pos,
            l_read_name,
            mapq,
            _bin,
            n_cigar,
            flag,
            l_seq,
            mate_ref,
            mate_pos,
            tlen,
        ) = struct.unpack_from("<iiBBHHHiiii", body, 0)
        off = 32
        name = body[off : off + l_read_name - 1].decode()
        off += l_read_name
        cigar = []
        for _ in range(n_cigar):
            (v,) = struct.unpack_from("<I", body, off)
            cigar.append((v >> 4, _CIGAR_OPS[v & 0xF]))
            off += 4
        seq_bytes = body[off : off + (l_seq + 1) // 2]
        off += (l_seq + 1) // 2
        chars = []
        for i in range(l_seq):
            b = seq_bytes[i // 2]
            code = (b >> 4) if i % 2 == 0 else (b & 0xF)
            chars.append(_SEQ_CODES[code])
        quals_raw = body[off : off + l_seq]
        off += l_seq
        qualities = None
        if l_seq and quals_raw[0] != 0xFF:
            qualities = "".join(chr(q + 33) for q in quals_raw)
        aln = ReadAlignment(
            sequence_name=self.sequence_names[ref_id] if ref_id >= 0 else None,
            first=pos + 1,
            cigar=cigar,
            flags=flag,
            read_name=name,
            read_chars="".join(chars),
            qualities=qualities,
            alignment_quality=mapq,
            mate_sequence_name=(
                self.sequence_names[mate_ref] if mate_ref >= 0 else None
            ),
            mate_first=mate_pos + 1 if mate_pos >= 0 else 0,
            inferred_insert_size=tlen,
        )
        # tags
        while off + 3 <= len(body):
            tag = body[off : off + 2].decode(errors="replace")
            typ = chr(body[off + 2])
            off += 3
            val, off = self._read_tag_value(body, off, typ)
            if val is None:
                break
            if tag == "NM":
                aln.num_mismatches = int(val)
            elif tag == "RG":
                aln.read_group = val
        return aln

    @staticmethod
    def _read_tag_value(body: bytes, off: int, typ: str):
        if typ in "cC":
            return body[off], off + 1
        if typ in "sS":
            return struct.unpack_from("<h" if typ == "s" else "<H", body, off)[0], off + 2
        if typ in "iI":
            return struct.unpack_from("<i" if typ == "i" else "<I", body, off)[0], off + 4
        if typ == "f":
            return struct.unpack_from("<f", body, off)[0], off + 4
        if typ == "A":
            return chr(body[off]), off + 1
        if typ in "ZH":
            end = body.index(b"\x00", off)
            return body[off:end].decode(errors="replace"), end + 1
        if typ == "B":
            sub = chr(body[off])
            (n,) = struct.unpack_from("<i", body, off + 1)
            size = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[sub]
            return None if n < 0 else [], off + 5 + n * size
        return None, off
