"""The frozen input generators give the repository's inputs byte for
byte: chip_smoke.real_size_inputs (at its seeds, 2024 for the genome, 7
for the individual, 11 and 12 for the reads, at small sizes) and the
port's simulators (at other seeds); and the composition of a configuration
(its sequences cut from one repeat genome, reads from every sequence)
holds what it says.  Only this test imports chip_smoke and the port's
simulators; the harness does not."""
import numpy as np
import pytest

import chip_smoke
from perfbench import inputs

MBP, N_READS = 0.3, 4000
SEQUENCES = [["chrI", 120_000], ["chrII", 50_000], ["chrIII", 130_000]]


def _ref_cfg(sequences=SEQUENCES):
    return {"sequences": sequences, "genome_seed": 2024, "repeat_families_per_12mbp": 30,
            "tandem_arrays_per_12mbp": 400}


SAMPLE = {"coverage": 4.0, "read_length": 150, "error_rate": 0.003, "base_quality": 40,
          "snv_rate": 0.001, "indel_rate": 0.0001}


def _reads(variants_of, codes, seeds, n):
    haps = inputs.haplotypes(codes, variants_of)
    parts = [inputs.simulate_reads(hap, n // 2, 150, 0.003, s, "chr1")
             for (hap, _), s in zip(haps, seeds)]
    return haps, np.concatenate([p[0] for p in parts]), [nm for p in parts for nm in p[3]]


@pytest.mark.parametrize("mbp", [MBP, 0.46])
def test_generators_give_real_size_inputs(mbp):
    want = chip_smoke.real_size_inputs(mbp, N_READS)
    codes, repeat_iv, tandem = inputs.repeat_genome(int(mbp * 1e6), 2024, 30, 400)
    assert np.array_equal(codes, want["codes"])
    assert np.array_equal(repeat_iv, want["repeat_iv"])
    assert tandem == want["tandem"]
    variants = inputs.simulate_individual(codes, 0.001, 0.0001, 7)
    assert {(v.first, v.alt) for v in variants if v.is_snv} == want["truth_snv"]
    assert np.array_equal(
        np.array([v.first for v in variants if not v.is_snv]), want["truth_indel_pos"])
    assert np.array_equal(inputs.repeat_mask(len(codes), repeat_iv, 150), want["in_repeat"])
    _, got_codes, got_names = _reads(variants, codes, (11, 12), N_READS)
    reads = want["reads"]
    assert got_codes.dtype == reads.codes.dtype and np.array_equal(got_codes, reads.codes)
    assert got_names == reads.names


@pytest.mark.parametrize("seed", [123456, 2**31 + 5])
def test_other_seeds_follow_the_port_simulators(seed):
    from ngsepcore_tpu_torch.simulation.individual_simulator import SingleIndividualSimulator
    from ngsepcore_tpu_torch.simulation.reads_simulator import SingleReadsSimulator

    k = chip_smoke.port_classes()
    codes = inputs.repeat_genome(int(MBP * 1e6), 2024, 30, 400)[0]
    seqs = k.QualifiedSequenceList()
    seqs.add(k.QualifiedSequence(name="chr1", codes=codes))
    genome = k.ReferenceGenome(seqs)
    sim = SingleIndividualSimulator(genome, snv_rate=0.001, indel_rate=0.0001, seed=seed)
    sim.simulate()
    variants = inputs.simulate_individual(codes, 0.001, 0.0001, seed)
    assert [(c.first, c.alleles[0], c.alleles[1], c.indexes_called_alleles == [0, 1])
            for c in sim.calls] == [(v.first, v.ref, v.alt, v.het) for v in variants]
    haps, got_codes, got_names = _reads(variants, codes, (seed + 1, seed + 2), N_READS)
    hgs = sim.build_haplotype_genomes()
    for (hap, hmap), hg in zip(haps, hgs):
        assert np.array_equal(hap, hg.sequences[0].codes)
        on_ref = hmap >= 0
        snv_pos = {v.first - 1 for v in variants if v.is_snv}
        same = on_ref & ~np.isin(hmap, list(snv_pos))
        assert np.array_equal(hap[same], codes[hmap[same]])
    blocks = [SingleReadsSimulator(hg, read_length=150, substitution_error_rate=0.003,
                                   seed=s).simulate_block(N_READS // 2)
              for hg, s in zip(hgs, (seed + 1, seed + 2))]
    want = k.ReadBlock.concatenate(blocks)
    assert np.array_equal(got_codes, want.codes)
    assert got_names == want.names


def test_sequences_are_cut_from_one_repeat_genome():
    ref = inputs.make_reference(_ref_cfg())
    whole, repeat_iv, _ = inputs.repeat_genome(300_000, 2024, 30, 400)
    assert ref.names == ["chrI", "chrII", "chrIII"]
    assert [len(s) for s in ref.seqs] == [120_000, 50_000, 130_000]
    assert np.array_equal(np.concatenate(ref.seqs), whole)
    # the repeat mask of each sequence is the whole genome's, cut the same way
    mask = np.zeros(len(whole), bool)
    for lo, hi in repeat_iv:
        mask[lo:hi] = True
    at = 0
    for seq, iv in zip(ref.seqs, ref.repeat_iv):
        own = np.zeros(len(seq), bool)
        for lo, hi in iv:
            own[lo:hi] = True
        assert np.array_equal(own, mask[at : at + len(seq)])
        at += len(seq)


@pytest.mark.parametrize("seed", [5, 2**31 + 17])
def test_a_sample_draws_every_sequence_and_places_its_reads(seed):
    ref = inputs.make_reference(_ref_cfg())
    s = inputs.make_sample(ref, SAMPLE, seed)
    counts = [int((s.seq_of == i).sum()) for i in range(3)]
    assert counts == [2 * inputs.reads_per_haplotype(len(q), SAMPLE) for q in ref.seqs]
    assert len(s) == sum(counts) == len(s.names) == len(s.codes)
    assert len(s.variants) == 3 and all(any(v.is_snv for v in var) for var in s.variants)
    # each read is the haplotype slice it says it came from (errors aside)
    for r in range(0, len(s), 97):
        hap = s.haps[s.seq_of[r]][s.hap_of[r]][0]
        codes = s.codes[r, :150]
        if s.reverse[r]:
            codes = np.where(codes[::-1] < 4, 3 - codes[::-1], codes[::-1])
        true = hap[s.start[r] : s.start[r] + 150]
        assert (codes != true).mean() < 0.05
        assert s.names[r].startswith(ref.names[s.seq_of[r]] + "_")
    # the reads are shuffled across sequences
    assert len(set(s.seq_of[:50].tolist())) > 1


def test_samples_differ_by_seed_and_index_and_keep_their_size():
    ref = inputs.make_reference(_ref_cfg())
    a = inputs.make_sample(ref, SAMPLE, 11)
    again = inputs.make_sample(ref, SAMPLE, 11)
    assert np.array_equal(a.codes, again.codes) and a.names == again.names
    for other in (inputs.make_sample(ref, SAMPLE, 11, 1), inputs.make_sample(ref, SAMPLE, 12)):
        assert len(other) == len(a)
        assert [(v.first, v.alt) for v in other.variants[0]] != [
            (v.first, v.alt) for v in a.variants[0]]
        assert not np.array_equal(other.codes, a.codes)
