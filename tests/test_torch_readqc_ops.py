"""The port's ReadQC ops (plain torch versions on the CPU) must equal the JAX
package's functions on the same inputs. Every output is an integer count, so
the tolerance is exact equality.

Inputs are made with numpy from a seed and handed to both packages. The
Pallas kernel runs in interpret mode, as in tests/test_pallas_kernels.py.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from ngsbits_tpu.ops import pallas_kernels as jpk
from ngsbits_tpu.ops import readqc as jops
from ngsbits_tpu.qc.read_stats import ReadStatistics as JaxReadStatistics
from ngsbits_tpu_torch.ops import KERNELS
from ngsbits_tpu_torch.ops import pallas_kernels as tpk
from ngsbits_tpu_torch.ops import readqc as tops
from ngsbits_tpu_torch.ops import selfcheck

CPU = torch.device("cpu")


def _reads(B, L, seed=0, lmin=1, qmin=33, qmax=73):
    rng = np.random.default_rng(seed)
    bases = rng.choice(np.frombuffer(b"ACGTN", dtype=np.uint8), size=(B, L))
    quals = rng.integers(qmin, qmax + 1, size=(B, L)).astype(np.uint8)
    lengths = rng.integers(lmin, L + 1, size=(B,)).astype(np.int32)
    return bases, quals, lengths


def _port_batch(bases, quals, lengths):
    out = tops.readqc_batch(torch.from_numpy(bases), torch.from_numpy(quals),
                            torch.from_numpy(lengths))
    return [t.numpy() for t in out]


_JAX_BATCH = {
    "pallas": lambda b, q, n: jpk.readqc_batch_pallas(b, q, n, interpret=True),
    "xla": jops.readqc_batch,
}


@pytest.mark.parametrize("ref", ["pallas", "xla"])
@pytest.mark.parametrize("B,L", [(64, 151), (24, 40), (128, 128)])
def test_readqc_batch_matches_jax(B, L, ref):
    bases, quals, lengths = _reads(B, L, seed=B + L)
    want = _JAX_BATCH[ref](bases, quals, lengths)
    got = _port_batch(bases, quals, lengths)
    for w, g, name in zip(want, got, ["counts5", "qsum_cycle", "qhist", "read_qsum"]):
        np.testing.assert_array_equal(np.asarray(w), g, err_msg=name)


@pytest.mark.parametrize("ref", ["pallas", "xla"])
def test_readqc_batch_out_of_range_quals_and_empty_reads(ref):
    """q outside [0, 100) is counted in the sums but not the histogram;
    reads of length 0 contribute nothing."""
    bases, quals, lengths = _reads(40, 72, seed=3, lmin=0, qmin=0, qmax=200)
    lengths[:5] = 0
    want = _JAX_BATCH[ref](bases, quals, lengths)
    got = _port_batch(bases, quals, lengths)
    assert (quals < 33).any() and (quals >= 133).any()
    for w, g, name in zip(want, got, ["counts5", "qsum_cycle", "qhist", "read_qsum"]):
        np.testing.assert_array_equal(np.asarray(w), g, err_msg=name)


@pytest.mark.parametrize("ref", ["pallas", "xla"])
@pytest.mark.parametrize("B,L,profile,qual_bits", [
    (96, 192, "binned", 6),    # binned qualities, as K1's main-path input
    (40, 1, "uniform", 8),     # one cycle
    (24, 300, "wide", 8),      # wider than one 256-column chunk; quals 0..255
    (1, 151, "binned", 6),     # one read
    (37, 151, "uniform", 6),   # B not a multiple of 16, L of 16 k + 7
])
def test_readqc_batch_edges_match_jax(B, L, profile, qual_bits, ref):
    """K1's plain version on the edge shapes and quality profiles that the
    kernel's paths split on, with random bytes past each read's length."""
    bases, quals, lengths, _ = selfcheck.reads(B, L, qual_bits, seed=B * L,
                                               profile=profile, n_valid=B,
                                               dirty=True)
    past = np.arange(L)[None, :] >= lengths[:, None]
    if past.sum() > 10:
        assert (bases[past] != 0).any() and (quals[past] != 0).any()
    want = _JAX_BATCH[ref](bases, quals, lengths)
    got = _port_batch(bases, quals, lengths)
    for w, g, name in zip(want, got, ["counts5", "qsum_cycle", "qhist", "read_qsum"]):
        np.testing.assert_array_equal(np.asarray(w), g, err_msg=name)


def test_binned_profile_holds_only_four_qualities():
    bases, quals, lengths, n_valid = selfcheck.reads(64, 192, 6, seed=3,
                                                     profile="binned", read_len=151)
    assert n_valid == 56 and (lengths[:56] == 151).all() and not lengths[56:].any()
    q = quals[:56, :151].astype(int) - 33
    assert set(np.unique(q)) <= {2, 12, 23, 37}
    # runs along the read: neighbouring cycles mostly share a bin
    assert (q[:, 1:] == q[:, :-1]).mean() > 0.8


# ---- stream step: unpack + K1 + tails against the JAX stream_step ----------

def _bucketed(B, L, seed, long_read=False, lmin=0):
    from ngsbits_tpu.io.fastq import FastqBatch
    qmax = 126 if long_read else 74
    bases, quals, lengths = _reads(B, L, seed=seed, lmin=lmin, qmax=qmax)
    mask = np.arange(L)[None, :] < lengths[:, None]
    batch = FastqBatch(bases=np.where(mask, bases, 0).astype(np.uint8),
                       quals=np.where(mask, quals, 0).astype(np.uint8),
                       lengths=lengths)
    return JaxReadStatistics._bucket(batch)


def _nonzero_carry(L, seed):
    rng = np.random.default_rng(seed)
    shapes = dict(counts5=(5, L), qsum1=(L,), qsum2=(L,), qhist=(100,),
                  read_q_hist=(100,), q20=(), qdist1=(60,), qdist2=(60,),
                  len_hist=(L + 1,), n_fwd=(), n_rev=(), bases=())
    return {k: rng.integers(0, 10_000, size=s).astype(np.int32)
            for k, s in shapes.items()}


def _jax_step(np_carry, pb, nm, pq, lengths, n_valid, direction, qual_bits):
    import jax.numpy as jnp
    carry = {k: jnp.asarray(v) for k, v in np_carry.items()}
    out = jops.stream_step()(carry, pb, nm, pq, lengths, np.int32(n_valid),
                             direction, qual_bits)
    return {k: np.asarray(v) for k, v in out.items()}


def _port_step(np_carry, pb, nm, pq, lengths, n_valid, direction, qual_bits):
    carry = tops.carry_from_numpy(np_carry, CPU)
    t = [torch.from_numpy(x) for x in (pb, nm, pq, lengths)]
    tops.stream_step(carry, *t, n_valid, direction, qual_bits)
    return tops.carry_to_numpy(carry)


@pytest.mark.parametrize("direction", [0, 1])
@pytest.mark.parametrize("qual_bits", [6, 8])
def test_stream_step_matches_jax_from_shared_carry(qual_bits, direction):
    bases, quals, lengths = _bucketed(300, 151, seed=qual_bits + direction,
                                      long_read=qual_bits == 8)
    L = bases.shape[1]
    pb, nm, pq = jops.pack_batch(bases, quals, qual_bits)
    np_carry = _nonzero_carry(L, seed=11)
    n_valid = 300
    want = _jax_step(np_carry, pb, nm, pq, lengths, n_valid, direction, qual_bits)
    got = _port_step(np_carry, pb, nm, pq, lengths, n_valid, direction, qual_bits)
    assert set(got) == set(want) == set(tops.CARRY_KEYS)
    for k in tops.CARRY_KEYS:
        assert got[k].dtype == np.int64, k
        np.testing.assert_array_equal(got[k], want[k].astype(np.int64), err_msg=k)


@pytest.mark.parametrize("qual_bits", [6, 8])
def test_stream_step_integer_rules_match_jax(qual_bits):
    """Hand-made reads on the edges of the rules: mean quality exactly 60
    (bin 59), exactly 20 (Q20), a rounding tie, empty reads that count and
    padding rows that do not."""
    L = 64
    B = 1024
    lengths = np.zeros(B, np.int32)
    quals = np.zeros((B, L), np.uint8)
    rows = [(10, [60] * 10), (7, [20] * 7), (4, [19, 20, 20, 19]),
            (2, [30, 31]), (0, []), (5, [0, 0, 0, 0, 1]), (3, [61, 60, 59]),
            (1, [93 if qual_bits == 8 else 63])]
    for i, (n, qs) in enumerate(rows):
        lengths[i] = n
        quals[i, :n] = np.array(qs, np.int32) + 33
    bases = np.where(np.arange(L)[None, :] < lengths[:, None], ord("G"), 0).astype(np.uint8)
    pb, nm, pq = jops.pack_batch(bases, quals, qual_bits)
    n_valid = len(rows)
    for direction in (0, 1):
        np_carry = _nonzero_carry(L, seed=direction)
        want = _jax_step(np_carry, pb, nm, pq, lengths, n_valid, direction, qual_bits)
        got = _port_step(np_carry, pb, nm, pq, lengths, n_valid, direction, qual_bits)
        for k in tops.CARRY_KEYS:
            np.testing.assert_array_equal(got[k], want[k].astype(np.int64), err_msg=k)


@pytest.mark.parametrize("direction", [0, 1])
@pytest.mark.parametrize("qual_bits", [6, 8])
def test_stream_step_unpacks_only_reads_into_dirty_scratch(qual_bits, direction):
    """A bucket with padding rows (n_valid < B) whose scratch buffers were
    filled with 0xFF first: the carries equal the JAX stream_step's from a
    shared nonzero carry, so no byte of a padding row is read; unpack wrote
    the reads' rows and left the padding rows as they were."""
    n_valid = 300
    bases, quals, lengths = _bucketed(n_valid, 151, seed=20 + qual_bits + direction,
                                      long_read=qual_bits == 8)
    B, L = bases.shape
    assert n_valid < B and not lengths[n_valid:].any()
    pb, nm, pq = jops.pack_batch(bases, quals, qual_bits)
    np_carry = _nonzero_carry(L, seed=13)
    want = _jax_step(np_carry, pb, nm, pq, lengths, n_valid, direction, qual_bits)
    carry = tops.carry_from_numpy(np_carry, CPU)
    scratch = {k: torch.full((B * L,), 0xFF, dtype=torch.uint8) for k in ("bases", "quals")}
    tops.stream_step(carry, *(torch.from_numpy(x) for x in (pb, nm, pq, lengths)),
                     n_valid, direction, qual_bits, scratch)
    got = tops.carry_to_numpy(carry)
    for k in tops.CARRY_KEYS:
        np.testing.assert_array_equal(got[k], want[k].astype(np.int64), err_msg=k)
    mask = np.arange(L)[None, :] < lengths[:n_valid, None]
    for k, ascii_rows in (("bases", bases), ("quals", quals)):
        rows = scratch[k].view(B, L).numpy()
        assert (rows[n_valid:] == 0xFF).all(), k
        np.testing.assert_array_equal(rows[:n_valid][mask], ascii_rows[:n_valid][mask],
                                      err_msg=k)


@pytest.mark.parametrize("qual_bits", [6, 8])
def test_unpack_restores_masked_reads(qual_bits):
    bases, quals, lengths = _bucketed(200, 100, seed=5, long_read=qual_bits == 8)
    pb, nm, pq = jops.pack_batch(bases, quals, qual_bits)
    L = bases.shape[1]
    got_b, got_q = tops.unpack(*(torch.from_numpy(x) for x in (pb, nm, pq)), L,
                               qual_bits)
    mask = np.arange(L)[None, :] < lengths[:, None]
    np.testing.assert_array_equal(got_b.numpy()[mask], bases[mask])
    np.testing.assert_array_equal(got_q.numpy()[mask], quals[mask])


def test_stream_carry_grow_pads_cycles_only():
    carry = tops.carry_from_numpy(_nonzero_carry(64, seed=2), CPU)
    grown = tops.stream_carry_grow(carry, 128)
    for k in tops.CARRY_KEYS:
        a, b = carry[k].numpy(), grown[k].numpy()
        if k in ("counts5", "qsum1", "qsum2", "len_hist"):
            assert b.shape[-1] == a.shape[-1] + 64, k
            np.testing.assert_array_equal(b[..., : a.shape[-1]], a, err_msg=k)
            assert not b[..., a.shape[-1]:].any(), k
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert tops.stream_carry_grow(grown, 64) is grown


def test_f1_carries_near_int32_limit_stay_exact():
    """Fault F1: the JAX stream's int32 carries wrap past 2**31. The port's
    int64 carries, started just below the limit, must equal the start plus
    one batch's contribution in Python integer arithmetic."""
    bases, quals, lengths = _bucketed(1500, 151, seed=9, lmin=100)
    L = bases.shape[1]
    pb, nm, pq = jops.pack_batch(bases, quals, 6)
    zero = {k: np.zeros_like(v) for k, v in _nonzero_carry(L, 0).items()}
    delta = _port_step(zero, pb, nm, pq, lengths, 1500, 0, 6)
    near = {k: np.full(v.shape, 2**31 - 50, dtype=np.int64)
            for k, v in zero.items()}
    got = _port_step(near, pb, nm, pq, lengths, 1500, 0, 6)
    for k in tops.CARRY_KEYS:
        want = [int(s) + int(d) for s, d in
                zip(near[k].ravel().tolist(), delta[k].ravel().tolist())]
        assert got[k].ravel().tolist() == want, k
    # the batch really crosses the int32 limit
    assert int(got["bases"]) > 2**31 - 1
    assert int(got["qhist"].max()) > 2**31 - 1
    assert int(got["counts5"].max()) > 2**31 - 1


def test_carry_roundtrip_and_missing_key():
    np_carry = _nonzero_carry(64, seed=4)
    back = tops.carry_to_numpy(tops.carry_from_numpy(np_carry, CPU))
    for k in tops.CARRY_KEYS:
        np.testing.assert_array_equal(back[k], np_carry[k])
    del np_carry["q20"]
    with pytest.raises(KeyError):
        tops.carry_from_numpy(np_carry, CPU)


# ---- dispatch rule ----------------------------------------------------------

def test_cpu_tensors_take_plain_version_without_counting():
    before = [k.launches for k in KERNELS]
    bases, quals, lengths = _reads(16, 64, seed=1)
    _port_batch(bases, quals, lengths)
    assert [k.launches for k in KERNELS] == before


def test_wrappers_refuse_other_devices():
    t = torch.zeros((4, 64), dtype=torch.uint8, device="meta")
    n = torch.zeros(4, dtype=torch.int32, device="meta")
    z = torch.zeros((5, 64), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        tpk.readqc_batch_into(t, t, n, z, z[0], z[0, :100], n)
    cpu = torch.zeros((4, 64), dtype=torch.uint8)
    with pytest.raises(ValueError):
        tpk.readqc_unpack_into(cpu[:, :16], cpu[:, :8], cpu[:, :48], 6, t, t)


def test_check_refuses_misaligned_output():
    """unpack stores four bytes at a time: a contiguous view at an odd
    offset must be refused before a launch, not fault on the card."""
    buf = torch.zeros(4 * 64 + 1, dtype=torch.uint8)
    aligned, odd = buf[:256].view(4, 64), buf[1:].view(4, 64)
    assert aligned.data_ptr() % 4 == 0 and odd.is_contiguous()
    tpk._check("bases", aligned, torch.uint8, (4, 64), align=4)
    with pytest.raises(ValueError, match="aligned"):
        tpk._check("bases", odd, torch.uint8, (4, 64), align=4)
