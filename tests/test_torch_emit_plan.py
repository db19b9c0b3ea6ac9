"""The untied emit kernel's stage plan, chosen on the host (CPU only).

``untied_plan`` picks the batch rows a launch, the stage height ``kc``
and the stage count of ``csrc/emit_norm_logits.cu``'s untied ring; the
kernel refuses a plan whose shared memory passes the card's 227 KB.
These tests hold the plan to what the kernel needs at every untied head
of the zoo: two to sixteen stages, a TMA box of at most 256 rows, shared
memory within the limit, every batch row in exactly one launch, and a
reason where nothing fits.  ``emit_tiles`` tiles a batch wider than one
launch takes over launches, tied and untied: every row in one tile, the
fewest tiles within the limit, the rows spread evenly.
"""
import pytest
import torch

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.kernels.emit_norm_logits.ops import (
    SMEM_LIMIT, TIED_FIXED, UNTIED_FIXED, UNTIED_MAX_ROWS, UNTIED_MAX_STAGES, emit_tiles,
    tied_max_rows, untied_cols, untied_plan,
)

UNTIED = [a for a in ARCH_IDS if not get_config(a).tie_embeddings]
DTYPES = [torch.bfloat16, torch.float32]


def _x_row_bytes(d, dtype):
    """A shared row of the normalised x: d padded to 64, bf16 rows 8
    elements more (the kernel's Untied<T>::ldx)."""
    return (-(-d // 64) * 64 + (8 if dtype == torch.bfloat16 else 0)) * dtype.itemsize


def test_every_untied_config_is_covered():
    assert len(UNTIED) == 8 and "moonshot-v1-16b-a3b" in UNTIED
    assert {a for a in ARCH_IDS if a not in UNTIED} == {"olmo-1b", "mamba2-1.3b"}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("b", [1, 8, 16])
@pytest.mark.parametrize("arch", UNTIED)
def test_untied_plan_fits_every_zoo_head(arch, b, dtype):
    d = get_config(arch).d_model
    p = untied_plan(b, d, dtype)
    assert 2 <= p.stages <= UNTIED_MAX_STAGES
    assert p.kc % 32 == 0 and 32 <= p.kc <= 256  # a TMA box has at most 256 rows
    assert p.kc <= -(-d // 32) * 32  # no stage taller than d needs
    assert 1 <= p.rows <= UNTIED_MAX_ROWS
    assert p.launches == -(-b // p.rows) and (p.launches - 1) * p.rows < b  # each row once
    stage = p.kc * untied_cols(dtype) * dtype.itemsize
    assert untied_cols(dtype) * dtype.itemsize == 256  # 256 bytes of each row of W a group
    assert p.smem == UNTIED_FIXED + p.stages * stage + p.rows * _x_row_bytes(d, dtype)
    assert p.smem <= SMEM_LIMIT
    if p.stages < UNTIED_MAX_STAGES:  # as many stages as fit
        assert p.smem + stage > SMEM_LIMIT
    if p.kc < 256 and p.kc < -(-d // 32) * 32:  # a taller stage would leave room for one only
        assert UNTIED_FIXED + 2 * 2 * stage + p.rows * _x_row_bytes(d, dtype) > SMEM_LIMIT
    if p.launches > 1:  # split only where the rows of one launch less would not fit
        assert (UNTIED_FIXED + 2 * 32 * 256 + -(-b // (p.launches - 1)) * _x_row_bytes(d, dtype)
                > SMEM_LIMIT)


@pytest.mark.parametrize("arch", UNTIED)
def test_untied_plan_reads_the_head_once_at_decode_batch(arch):
    """At the served batch of 8 rows in bf16, every zoo head takes one
    launch: the head is read once."""
    assert untied_plan(8, get_config(arch).d_model, torch.bfloat16).launches == 1


def test_untied_plan_at_moonlight_decode():
    """Moonlight's decode emit (B 8, d 2048): bf16, 3 stages of 256 rows
    by 128 columns (64 KB each) beside 33 KB of normalised x; fp32, 2
    stages of 256 rows by 64 columns beside 64 KB."""
    assert tuple(untied_plan(8, 2048, torch.bfloat16)) == (8, 1, 256, 3, 2048 + 3 * 65536 + 32896)
    assert tuple(untied_plan(8, 2048, torch.float32)) == (8, 1, 256, 2, 2048 + 2 * 65536 + 65536)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", [64, 256, 2048, 8192])
def test_untied_plan_refuses_an_over_wide_batch(dtype, d):
    untied_plan(UNTIED_MAX_ROWS, d, dtype)
    with pytest.raises(ValueError, match=f"at most {UNTIED_MAX_ROWS} rows"):
        untied_plan(UNTIED_MAX_ROWS + 1, d, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_untied_plan_refuses_a_row_that_does_not_fit(dtype):
    """One row of x so wide that two of the smallest stages do not fit
    beside it: a reason, not a launch error."""
    d = (SMEM_LIMIT // dtype.itemsize) // 64 * 64
    with pytest.raises(ValueError, match="no room for two stages"):
        untied_plan(1, d, dtype)


TILE_BATCHES = [1, 8, 48, 49, 64, 65, 128, 256]


def _tied_smem(rows, d, dtype):
    """The tied kernel's shared memory for ``rows`` rows: the normalised x
    padded by 32 elements a row, the fp32 scale, its own 20 KB."""
    return rows * (d + 32) * dtype.itemsize + 4 * d + TIED_FIXED


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", [2048, 8192])
@pytest.mark.parametrize("b", TILE_BATCHES)
def test_emit_tiles_cover_the_batch_within_one_launch_each(b, d, dtype, tied):
    tiles = emit_tiles(b, d, dtype, tied)
    limit = tied_max_rows(d, dtype) if tied else UNTIED_MAX_ROWS
    assert tiles[0][0] == 0 and tiles[-1][1] == b
    assert all(a[1] == c[0] for a, c in zip(tiles, tiles[1:]))  # each row once, in order
    sizes = [r1 - r0 for r0, r1 in tiles]
    assert all(1 <= n <= limit for n in sizes)
    assert len(tiles) == -(-b // limit)  # the fewest launches
    assert sizes[0] == -(-b // len(tiles)) and all(n == sizes[0] for n in sizes[:-1])
    assert b - sizes[0] * (len(tiles) - 1) == sizes[-1] > 0  # spread evenly
    for n in sizes:
        if tied:
            assert _tied_smem(n, d, dtype) <= SMEM_LIMIT
        else:
            assert untied_plan(n, d, dtype).smem <= SMEM_LIMIT


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", [2048, 8192])
def test_tied_max_rows_is_the_most_that_fit(d, dtype):
    rows = tied_max_rows(d, dtype)
    assert _tied_smem(rows, d, dtype) <= SMEM_LIMIT < _tied_smem(rows + 1, d, dtype)


def test_emit_tiles_at_the_old_limits():
    """The tied bf16 head at d 2048 held 48 rows in one launch and refused
    49; the untied head held 64.  Past them the batch now tiles."""
    assert emit_tiles(48, 2048, torch.bfloat16, True) == [(0, 48)]
    assert emit_tiles(49, 2048, torch.bfloat16, True) == [(0, 25), (25, 49)]
    assert emit_tiles(64, 2048, torch.bfloat16, False) == [(0, 64)]
    assert emit_tiles(65, 2048, torch.bfloat16, False) == [(0, 33), (33, 65)]
    assert len(emit_tiles(256, 2048, torch.bfloat16, True)) == 6
    assert emit_tiles(256, 2048, torch.float32, False) == [(0, 64), (64, 128), (128, 192),
                                                           (192, 256)]


def test_tied_max_rows_refuses_a_row_that_does_not_fit():
    with pytest.raises(ValueError, match="does not fit"):
        tied_max_rows(SMEM_LIMIT // 2, torch.bfloat16)
