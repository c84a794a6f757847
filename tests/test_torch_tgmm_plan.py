"""K6's launch plan (``ops.plan_grouped_matmul_tgmm``) and a numpy emulation
of the kernel's tile walk (``csrc/grouped_matmul_tgmm.cu``) written over the
plan's integers, held against megablox ``tgmm`` in Pallas interpret mode
and against ``grouped_matmul_tgmm_plain``, on the CPU.

The emulation follows the kernel step by step: persistent blocks walk the
flat tile list (group outermost, then 128-row d tiles, 256-column f tiles)
with ``tile += grid``, each keeping a running row offset that only moves
forward; a tile's contraction runs over k tiles of 64 rows starting at its
group's first row, each operand read as TMA reads a box (zeros past
``rows``, ``d`` and ``f``); in the last k tile the rows at or past the
group's end are zeroed in both operands; an empty group's tile stores
zeros; each warpgroup's accumulators go through the epilogue's swizzled
staging writes and come back as TMA's store reads them, and the store is
clipped at the d and f edges. Every tile must be written exactly once.

Tolerance: the inputs are bf16 values held in float32, so every product
is exact and only the order of the float32 sums differs from megablox's
and the plain version's: rtol 1e-5 + atol 1e-4 over at most a few hundred
terms of magnitude ~1.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu_torch import ops as t_ops

TOL = dict(rtol=1e-5, atol=1e-4)
megablox = importlib.import_module("jax.experimental.pallas.ops.tpu.megablox.gmm")
SMEM_MAX = 232_448  # bytes a block may use on Hopper


# -- the plan ------------------------------------------------------------------

@pytest.mark.parametrize("d,f", [(2048, 768), (768, 2048)])
def test_qwen3_train_forms_walk_6144_tiles_over_every_sm(d, f):
    plan = t_ops.plan_grouped_matmul_tgmm(128, d, f, 132)
    assert plan["tiles"] == 6144
    assert plan["grid"] == (132, 1, 1)
    assert plan["threads"] == 384 and plan["tile"] == (128, 256, 64) and plan["stages"] == 3
    assert plan["smem"] <= SMEM_MAX


@pytest.mark.parametrize("n_groups,d,f,sm_count", [
    (1, 8, 8, 132), (3, 200, 264, 132), (128, 2048, 768, 7), (8, 128, 256, 1),
    (65535, 8, 8, 132), (2, 4096, 4096, 16), (1, 128, 256, 132),
])
def test_grid_never_exceeds_the_sms_or_the_tiles(n_groups, d, f, sm_count):
    plan = t_ops.plan_grouped_matmul_tgmm(n_groups, d, f, sm_count)
    assert plan["tiles"] == n_groups * -(-d // 128) * -(-f // 256)
    assert 1 <= plan["grid"][0] <= min(sm_count, plan["tiles"])
    assert plan["grid"][1:] == (1, 1)
    assert all(isinstance(v, int) for v in plan["grid"])


@pytest.mark.parametrize("n_groups,d,f", [
    (0, 128, 256), (65536, 128, 256), (8, 0, 256), (8, 128, 0), (8, 12, 256),
    (8, 128, 260), (8, 4, 256), (8, -8, 256),
])
def test_refused_shapes_stay_refused(n_groups, d, f):
    """The shapes the wrapper refused before the redesign (``d``, ``f`` not
    positive multiples of 8; groups outside 1..65535) are still refused."""
    with pytest.raises(ValueError):
        t_ops.plan_grouped_matmul_tgmm(n_groups, d, f, 132)


# -- the epilogue's staging layout ---------------------------------------------

def _epilogue_permutation() -> np.ndarray:
    """Where each of a warpgroup's 64 x 256 accumulators lands after the
    kernel's epilogue: thread 32 w + 4 gq + tq holds, for j < 32, acc[4j +
    {0, 1}] at row 16 w + gq, columns 8 j + 2 tq + {0, 1}, and acc[4j + {2,
    3}] at row + 8; it writes each pair to byte (j >> 3) * 8192 + row * 128
    + (((j & 7) ^ gq) << 4) + 4 tq of the staging tile. The TMA store reads
    box q's element (r, c) from byte q * 8192 + r * 128 + (((c >> 3) ^ (r %
    8)) << 4) + 2 (c % 8) (128B swizzle). Returns, for each output element
    (r, 64 q + c), the flat index of the accumulator the store sends
    there."""
    staging = np.full(4 * 8192 // 2, -1, np.int64)
    w, gq, tq, j, h, e = np.meshgrid(range(4), range(8), range(4), range(32), range(2), range(2),
                                     indexing="ij")
    row = 16 * w + gq + 8 * h
    col = 8 * j + 2 * tq + e
    byte = (j >> 3) * 8192 + (16 * w + gq) * 128 + 8 * 128 * h + (((j & 7) ^ gq) << 4) + 4 * tq + 2 * e
    staging[(byte >> 1).ravel()] = (row * 256 + col).ravel()
    q, r, c = np.meshgrid(range(4), range(64), range(64), indexing="ij")
    read = (q * 8192 + r * 128 + (((c >> 3) ^ (r % 8)) << 4) + 2 * (c % 8)) >> 1
    return staging[read].transpose(1, 0, 2).reshape(64, 256)


EPILOGUE = _epilogue_permutation()


def test_epilogue_staging_matches_the_tma_store_swizzle():
    """Every staging slot is written once, and the store reads back each
    accumulator at its own (row, column)."""
    assert (EPILOGUE >= 0).all()
    assert np.array_equal(EPILOGUE, np.arange(64 * 256).reshape(64, 256))


def test_epilogue_fragment_writes_are_free_of_bank_conflicts():
    """One store instruction of a warp (fixed j and half): its 32 lanes'
    4-byte writes fall in 32 distinct banks."""
    gq, tq = np.meshgrid(range(8), range(4), indexing="ij")
    for j in range(32):
        for h in range(2):
            byte = (j >> 3) * 8192 + (gq + 8 * h) * 128 + (((j & 7) ^ gq) << 4) + 4 * tq
            assert len(set(((byte // 4) % 32).ravel())) == 32


# -- the tile walk --------------------------------------------------------------

def _box(x: np.ndarray, r0: int, c0: int, n_rows: int, n_cols: int) -> np.ndarray:
    """A TMA box: ``x[r0 : r0 + n_rows, c0 : c0 + n_cols]``, zeros outside."""
    out = np.zeros((n_rows, n_cols), np.float32)
    part = x[r0 : r0 + n_rows, c0 : c0 + n_cols]
    out[: part.shape[0], : part.shape[1]] = part
    return out


def emulate_tgmm(lhs: np.ndarray, dout: np.ndarray, sizes, plan: dict) -> np.ndarray:
    """K6's tile walk in numpy, from the plan's integers: float32 ``[E, d,
    f]`` (unrounded: the kernel rounds this once to bf16)."""
    rows, d = lhs.shape
    f = dout.shape[1]
    n_groups = len(sizes)
    tm, tn, tk = plan["tile"]
    n_d, n_f = -(-d // tm), -(-f // tn)
    assert plan["tiles"] == n_groups * n_d * n_f
    out = np.full((n_groups, d, f), np.nan, np.float32)  # torch.empty: unwritten shows
    written = np.zeros(plan["tiles"], np.int64)
    grid = plan["grid"][0]
    for block in range(grid):
        walk_g, start = 0, 0  # GroupWalk
        for tile in range(block, plan["tiles"], grid):
            g, rem = divmod(tile, n_d * n_f)
            d0, f0 = rem // n_f * tm, rem % n_f * tn
            assert g >= walk_g
            while walk_g < g:
                start += max(int(sizes[walk_g]), 0)
                walk_g += 1
            r0 = min(start, rows)
            r1 = min(start + max(int(sizes[g]), 0), rows)
            acc = np.zeros((tm, tn), np.float32)
            for k0 in range(r0, r1, tk):
                a = _box(lhs, k0, d0, tk, tm)  # two 64 d x 64 row boxes
                b = _box(dout, k0, f0, tk, tn)  # four 64 f x 64 row boxes
                valid = r1 - k0
                if valid < tk:  # rows of the next groups: zeroed in both
                    a[valid:] = 0
                    b[valid:] = 0
                acc += a.T @ b
            for wg in range(tm // 64):
                part = acc[64 * wg : 64 * wg + 64].reshape(-1)[EPILOGUE]
                dr = d0 + 64 * wg
                if dr < d:  # the store, clipped at the d and f edges
                    sub = out[g, dr : dr + 64, f0 : f0 + tn]
                    sub[...] = part[: sub.shape[0], : sub.shape[1]]
            written[tile] += 1
    assert (written == 1).all()
    return out


def _as_bf16_values(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


#: (sizes, rows past the last group, d, f); rows past the last group are a
#: multiple of 8, megablox's row tile below
CASES = {
    "empty_and_one_row_groups": ([0, 1, 70, 0, 64, 129, 3, 5], 0, 128, 256),
    "groups_not_multiples_of_64": ([65, 127, 63, 1, 200, 64, 5, 35], 0, 128, 256),
    "rows_past_the_last_group": ([65, 127, 63, 1, 200, 64, 5, 35], 16, 128, 256),
    "off_tile_widths": ([0, 1, 70, 0, 64, 129, 3, 5], 8, 200, 264),
    "narrower_than_a_box": ([65, 127, 63, 1, 200, 64, 5, 35], 0, 40, 72),
    "many_tiles_a_block": ([30, 0, 90, 17, 64, 1, 0, 118], 24, 264, 520),
}


def _problem(seed, sizes, tail, d, f):
    rng = np.random.default_rng(seed)
    rows = sum(max(n, 0) for n in sizes) + tail
    lhs = _as_bf16_values(rng.normal(size=(rows, d)).astype(np.float32))
    dout = _as_bf16_values(rng.normal(size=(rows, f)).astype(np.float32))
    return lhs, dout


def _megablox(lhs, dout, sizes):
    return np.asarray(megablox.tgmm(
        jnp.asarray(lhs).T, jnp.asarray(dout), jnp.asarray(np.asarray(sizes, np.int32)),
        preferred_element_type=jnp.float32, tiling=(8, 128, 128), interpret=True,
    ))


def _plain(lhs, dout, sizes):
    return t_ops.grouped_matmul_tgmm_plain(
        torch.from_numpy(lhs), torch.from_numpy(dout), torch.tensor(sizes, dtype=torch.int32)
    ).numpy()


@pytest.mark.parametrize("sm_count", [3, 132])
@pytest.mark.parametrize("case", list(CASES))
def test_emulated_walk_matches_megablox_and_plain(case, sm_count):
    sizes, tail, d, f = CASES[case]
    lhs, dout = _problem(11, sizes, tail, d, f)
    out = emulate_tgmm(lhs, dout, sizes, t_ops.plan_grouped_matmul_tgmm(len(sizes), d, f, sm_count))
    np.testing.assert_allclose(out, _megablox(lhs, dout, sizes), **TOL)
    np.testing.assert_allclose(out, _plain(lhs, dout, sizes), **TOL)
    assert not out[[g for g, n in enumerate(sizes) if n == 0]].any()


@pytest.mark.parametrize("d,f", [(128, 256), (200, 264)])
def test_nan_in_neighbouring_groups_does_not_leak(d, f):
    """NaN in every row of the odd groups and past the last group: the even
    groups' slices are finite and equal megablox's (which masks both
    operands too) and the plain version's."""
    sizes = [65, 127, 63, 1, 200, 64, 5, 35, 0, 24]
    lhs, dout = _problem(12, sizes, 16, d, f)
    ends = np.cumsum(sizes)
    for g in range(1, len(sizes), 2):
        lhs[ends[g] - sizes[g] : ends[g]] = np.nan
        dout[ends[g] - sizes[g] : ends[g]] = np.nan
    lhs[ends[-1]:] = np.nan
    dout[ends[-1]:] = np.nan
    out = emulate_tgmm(lhs, dout, sizes, t_ops.plan_grouped_matmul_tgmm(len(sizes), d, f, 132))
    assert np.isfinite(out[0::2]).all()
    np.testing.assert_allclose(out[0::2], _megablox(lhs, dout, sizes)[0::2], **TOL)
    np.testing.assert_allclose(out[0::2], _plain(lhs, dout, sizes)[0::2], **TOL)


@pytest.mark.parametrize("sizes,rows", [
    ([-5, 40, -1, 70, 0, 33, -100, 20], 163),  # negative sizes count as 0
    ([40, 70, 90, 33], 150),  # the sums clamped to rows: 40, 70, the rest of 40
    ([-3, 0, 0, 7], 7),  # one group, at the end
])
def test_emulated_walk_clamps_sizes_as_the_plain_version(sizes, rows):
    """Negative sizes and sums past ``rows`` (megablox has no such case):
    the walk clamps as the plain version and K4 do."""
    rng = np.random.default_rng(13)
    lhs = _as_bf16_values(rng.normal(size=(rows, 128)).astype(np.float32))
    dout = _as_bf16_values(rng.normal(size=(rows, 256)).astype(np.float32))
    out = emulate_tgmm(lhs, dout, sizes, t_ops.plan_grouped_matmul_tgmm(len(sizes), 128, 256, 2))
    np.testing.assert_allclose(out, _plain(lhs, dout, sizes), **TOL)
