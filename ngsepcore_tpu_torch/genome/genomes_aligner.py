"""GenomesAligner — whole-genome ortholog/synteny comparison.

Ref: src/ngsep/genome/GenomesAligner.java (command `GenomesAligner`):
per-genome annotated units (gene -> cDNA/protein), ortholog/paralog
detection via 6-mer similarity (HomologRelationshipsFinder), orthogroup
clustering via MCL (HomologClustersCalculator), pairwise synteny blocks
(LCS family of finders), text + D3 visualization outputs.  This engine
produces the orthogroups and synteny text outputs.  Counterpart of
ngsepcore_tpu/genome/genomes_aligner.py; the orthogroups' MCL runs on the
caller's device.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.genome import ReferenceGenome
from ..core.sequences import decode_dna, reverse_complement
from ..transcriptome.model import Transcriptome
from ..transcriptome.protein import ProteinTranslator
from .homologs import HomologRelationshipsFinder, calculate_orthogroups
from .synteny import SyntenyBlock, find_synteny_blocks


@dataclass
class AnnotatedGene:
    genome_idx: int
    gene_id: str
    sequence_name: str
    position: int
    protein: str


def extract_proteins(
    genome: ReferenceGenome, transcriptome: Transcriptome, genome_idx: int
) -> list[AnnotatedGene]:
    """Longest-transcript protein per gene (ref: AnnotatedReferenceGenome)."""
    translator = ProteinTranslator()
    best: dict[str, AnnotatedGene] = {}
    for t in transcriptome.transcripts.values():
        cds_pos = t.cds_genomic_positions()
        if len(cds_pos) < 3:
            continue
        si = genome.index_of(t.sequence_name)
        if si < 0:
            continue
        bases = []
        for p in cds_pos if not t.negative_strand else cds_pos:
            b = genome.reference_string(si, p, p)
            bases.append(b)
        dna = "".join(bases)
        if t.negative_strand:
            dna = "".join(reverse_complement(b) for b in bases)
        protein = translator.translate(dna)
        gid = t.gene_id or t.transcript_id
        prev = best.get(gid)
        if prev is None or len(protein) > len(prev.protein):
            best[gid] = AnnotatedGene(
                genome_idx=genome_idx,
                gene_id=gid,
                sequence_name=t.sequence_name,
                position=t.first,
                protein=protein,
            )
    return list(best.values())


class GenomesAligner:
    def __init__(
        self, k: int = 6, min_pct: float = 11.0, min_block_genes: int = 3, *, device
    ):
        self.device = device
        self.k = k
        self.min_pct = min_pct
        self.min_block_genes = min_block_genes
        self.genes: list[AnnotatedGene] = []
        self.genome_offsets: list[int] = []

    def add_genome(self, genome: ReferenceGenome, transcriptome: Transcriptome):
        self.genome_offsets.append(len(self.genes))
        self.genes.extend(extract_proteins(genome, transcriptome, len(self.genome_offsets) - 1))

    def run(self) -> tuple[list[list[int]], list[SyntenyBlock]]:
        """Returns (orthogroups over global gene indices, synteny blocks
        between genome 0 and genome 1)."""
        seqs = [g.protein for g in self.genes]
        groups = calculate_orthogroups(seqs, self.k, self.min_pct, device=self.device)
        blocks: list[SyntenyBlock] = []
        if len(self.genome_offsets) >= 2:
            rels = HomologRelationshipsFinder(self.k, self.min_pct).find_homologs(seqs)
            g1_range = range(
                self.genome_offsets[0],
                self.genome_offsets[1] if len(self.genome_offsets) > 1 else len(self.genes),
            )
            lim1 = (
                self.genome_offsets[1]
                if len(self.genome_offsets) > 1
                else len(self.genes)
            )
            lim2 = (
                self.genome_offsets[2]
                if len(self.genome_offsets) > 2
                else len(self.genes)
            )
            pairs = []
            for r in rels:
                a, b = r.seq1, r.seq2
                if a >= lim1:
                    a, b = b, a
                if a < lim1 <= b < lim2:
                    pairs.append((a, b - lim1))
            gp1 = [
                (g.sequence_name, g.position) for g in self.genes[: lim1]
            ]
            gp2 = [
                (g.sequence_name, g.position) for g in self.genes[lim1:lim2]
            ]
            blocks = find_synteny_blocks(
                gp1, gp2, pairs, min_block_genes=self.min_block_genes
            )
        return groups, blocks

    def write_outputs(self, prefix: str, groups, blocks) -> None:
        with open(prefix + "_orthogroups.txt", "w") as fh:
            for i, g in enumerate(groups):
                names = [f"g{self.genes[x].genome_idx}:{self.genes[x].gene_id}" for x in g]
                fh.write(f"OG{i + 1}\t" + "\t".join(names) + "\n")
        with open(prefix + "_synteny.txt", "w") as fh:
            fh.write("SEQ1\tFIRST1\tLAST1\tSEQ2\tFIRST2\tLAST2\tGENES\tSTRAND\n")
            for b in blocks:
                fh.write(
                    f"{b.seq1}\t{b.first1}\t{b.last1}\t{b.seq2}\t{b.first2}\t"
                    f"{b.last2}\t{b.n_orthologs}\t{'+' if b.same_strand else '-'}\n"
                )
        if blocks:
            self.write_linear_view(prefix + "_linearOrthologView.html", blocks)

    def write_linear_view(self, path: str, blocks) -> None:
        """Self-contained INTERACTIVE linear synteny visualization.

        Ref: GenomesAligner.printD3Visualization (GenomesAligner.java:717-
        884) emits an HTML page + JS data file rendered with d3 from a CDN
        (GenomesAlignerLinearOrthologVisualizer.js).  This environment
        (and many analysis clusters) has no network, so the equivalent
        here is a standalone SVG ribbon view with inline vanilla-JS
        interactions matching the d3 app's capability: wheel zoom around
        the cursor, drag pan, ribbon hover tooltips, and click-to-isolate
        per target sequence — zero external dependencies.
        """
        # lay out sequences of each genome along x
        seqs1: dict[str, int] = {}
        seqs2: dict[str, int] = {}
        for b in blocks:
            seqs1[b.seq1] = max(seqs1.get(b.seq1, 0), b.last1)
            seqs2[b.seq2] = max(seqs2.get(b.seq2, 0), b.last2)
        W, H, GAP = 1200, 360, 8
        y1, y2 = 80, 280

        def layout(seqs):
            total = sum(seqs.values()) or 1
            scale = (W - 40 - GAP * max(0, len(seqs) - 1)) / total
            offs, x = {}, 20.0
            for name in sorted(seqs):
                offs[name] = (x, scale)
                x += seqs[name] * scale + GAP
            return offs

        offs1, offs2 = layout(seqs1), layout(seqs2)
        palette = ["#4e79a7", "#f28e2b", "#e15759", "#76b7b2", "#59a14f",
                   "#edc948", "#b07aa1", "#ff9da7", "#9c755f", "#bab0ac"]
        colors = {n: palette[i % len(palette)] for i, n in enumerate(sorted(seqs2))}
        parts = [
            f'<svg id="synteny" xmlns="http://www.w3.org/2000/svg" '
            f'width="{W}" height="{H}" viewBox="0 0 {W} {H}" '
            f'font-family="sans-serif" font-size="11">',
            '<g id="view">',
        ]
        for name, (x, sc) in offs1.items():
            w = seqs1[name] * sc
            parts.append(
                f'<rect x="{x:.1f}" y="{y1 - 10}" width="{w:.1f}" height="14" '
                f'fill="#ccc"/><text x="{x:.1f}" y="{y1 - 16}">{name}</text>'
            )
        for name, (x, sc) in offs2.items():
            w = seqs2[name] * sc
            parts.append(
                f'<rect x="{x:.1f}" y="{y2 - 4}" width="{w:.1f}" height="14" '
                f'fill="{colors[name]}" fill-opacity="0.5"/>'
                f'<text x="{x:.1f}" y="{y2 + 26}">{name}</text>'
            )
        for b in blocks:
            x1a = offs1[b.seq1][0] + b.first1 * offs1[b.seq1][1]
            x1b = offs1[b.seq1][0] + b.last1 * offs1[b.seq1][1]
            x2a = offs2[b.seq2][0] + b.first2 * offs2[b.seq2][1]
            x2b = offs2[b.seq2][0] + b.last2 * offs2[b.seq2][1]
            if not b.same_strand:
                x2a, x2b = x2b, x2a
            c = colors[b.seq2]
            label = (
                f"{b.seq1}:{b.first1}-{b.last1} ↔ "
                f"{b.seq2}:{b.first2}-{b.last2} ({b.n_orthologs} genes, "
                f"{'+' if b.same_strand else '-'})"
            )
            parts.append(
                f'<path class="ribbon" data-seq2="{b.seq2}" '
                f'data-label="{label}" '
                f'd="M{x1a:.1f},{y1 + 4} L{x1b:.1f},{y1 + 4} '
                f'L{x2b:.1f},{y2 - 4} L{x2a:.1f},{y2 - 4} Z" fill="{c}" '
                f'fill-opacity="0.35" stroke="{c}" stroke-width="0.5"/>'
            )
        parts.append("</g></svg>")
        script = """
<div id="tip" style="position:fixed;display:none;background:#222;color:#eee;
padding:4px 8px;border-radius:4px;font:12px sans-serif;pointer-events:none;
z-index:10"></div>
<p style="font:12px sans-serif;color:#555">wheel: zoom &middot; drag: pan
&middot; hover ribbon: details &middot; click ribbon: isolate target
sequence &middot; double-click: reset</p>
<script>
(function(){
  var svg = document.getElementById('synteny');
  var W = svg.viewBox.baseVal.width, H = svg.viewBox.baseVal.height;
  var vb = {x:0, y:0, w:W, h:H};
  function apply(){
    svg.setAttribute('viewBox', vb.x+' '+vb.y+' '+vb.w+' '+vb.h);
  }
  svg.addEventListener('wheel', function(e){
    e.preventDefault();
    var k = e.deltaY < 0 ? 0.85 : 1/0.85;
    var r = svg.getBoundingClientRect();
    var mx = vb.x + (e.clientX - r.left) / r.width * vb.w;
    var my = vb.y + (e.clientY - r.top) / r.height * vb.h;
    vb.w *= k; vb.h *= k;
    vb.x = mx - (mx - vb.x) * k;
    vb.y = my - (my - vb.y) * k;
    apply();
  });
  var drag = null;
  svg.addEventListener('mousedown', function(e){
    drag = {x: e.clientX, y: e.clientY, vx: vb.x, vy: vb.y};
  });
  window.addEventListener('mousemove', function(e){
    if(!drag) return;
    var r = svg.getBoundingClientRect();
    vb.x = drag.vx - (e.clientX - drag.x) / r.width * vb.w;
    vb.y = drag.vy - (e.clientY - drag.y) / r.height * vb.h;
    apply();
  });
  window.addEventListener('mouseup', function(){ drag = null; });
  svg.addEventListener('dblclick', function(){
    vb = {x:0, y:0, w:W, h:H}; apply(); isolate(null);
  });
  var tip = document.getElementById('tip');
  var sel = null;
  function isolate(seq){
    sel = seq;
    document.querySelectorAll('.ribbon').forEach(function(p){
      p.style.opacity = (seq === null || p.dataset.seq2 === seq) ? 1 : 0.06;
    });
  }
  document.querySelectorAll('.ribbon').forEach(function(p){
    p.addEventListener('mousemove', function(e){
      tip.style.display = 'block';
      tip.style.left = (e.clientX + 12) + 'px';
      tip.style.top = (e.clientY + 12) + 'px';
      tip.textContent = p.dataset.label;
      p.setAttribute('fill-opacity', '0.7');
    });
    p.addEventListener('mouseleave', function(){
      tip.style.display = 'none';
      p.setAttribute('fill-opacity', '0.35');
    });
    p.addEventListener('click', function(e){
      e.stopPropagation();
      isolate(sel === p.dataset.seq2 ? null : p.dataset.seq2);
    });
  });
})();
</script>"""
        with open(path, "w") as fh:
            fh.write(
                "<!DOCTYPE html>\n<html><head><meta charset='utf-8'>"
                "<title>Linear ortholog view</title></head><body>\n"
                "<h2>Synteny blocks</h2>\n"
                + "\n".join(parts)
                + script
                + "\n</body></html>\n"
            )
