"""How the attention kernels split their key axis over blocks (CPU only).

``decode_split`` and ``flash_split`` pick the split on the host; the
kernels (``csrc/decode_attention.cu``, ``csrc/flash_attention.cu``) then
give split ``sp`` of a row the keys ``[sp * size, min(end, (sp + 1) *
size))`` and let a split that starts at or past ``end`` exit.  These
tests hold the host's choice to what the kernels need: every key row in
exactly one split, no split empty by construction, a grid that reaches
toward the SM count where the shape allows it (decode: a few blocks an
SM; flash: at most one), and scratch for every partial the kernels
write.
"""
import pytest

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops

H100_SMS = 132
TILE = 64


def _live_splits(end: int, size: int) -> list[tuple[int, int]]:
    """The key ranges of the splits that do not exit at once, by the
    kernels' rule: max(1, ceil(end / size)) splits, the first one live
    even when ``end`` is 0 (it writes the zero output)."""
    live = max(1, -(-end // size))
    return [(sp * size, min(end, (sp + 1) * size)) for sp in range(live)]


DECODE_SHAPES = [  # b, kv, s
    (8, 16, 1024),   # OLMo-1B's decode step
    (8, 8, 1024),    # qwen3-32b's GQA widths
    (1, 16, 1000),
    (1, 1, 64),
    (64, 16, 1024),
    (4, 2, 100),
    (3, 2, 70),
    (2, 4, 8192),
    (1, 8, 1),
]


@pytest.mark.parametrize("b,kv,s", DECODE_SHAPES, ids=str)
def test_decode_split_covers_every_row_once(b, kv, s):
    rows, splits = da_ops.decode_split(b, kv, s, H100_SMS)
    assert rows > 0 and rows % TILE == 0
    assert splits == -(-s // rows)  # the kernel's grid
    assert (splits - 1) * rows < s <= splits * rows  # no split empty by construction
    for n in sorted({0, 1, s // 3, s - 1, s}):
        ranges = _live_splits(n, rows)
        assert len(ranges) <= splits
        covered = [k for lo, hi in ranges for k in range(lo, hi)]
        assert covered == list(range(n))  # each valid key once, in order


@pytest.mark.parametrize("b,kv,s", DECODE_SHAPES, ids=str)
def test_decode_split_fills_the_card(b, kv, s):
    rows, splits = da_ops.decode_split(b, kv, s, H100_SMS)
    tiles = -(-s // TILE)
    if b * kv * tiles >= H100_SMS:
        assert b * kv * splits >= H100_SMS
    else:
        assert splits == tiles  # one tile a split: as wide as S allows
    # never more than WAVES blocks an SM beyond what one more tile a split would give
    assert b * kv * (splits - 1) < da_ops.WAVES * H100_SMS or rows == TILE


def test_decode_split_at_olmo_shape():
    assert da_ops.decode_split(8, 16, 1024, H100_SMS) == (256, 4)
    assert da_ops.decode_split(64, 16, 1024, H100_SMS) == (1024, 1)


@pytest.mark.parametrize("b,h,dh,s", [(8, 16, 128, 1024), (8, 64, 128, 1024), (1, 4, 32, 100),
                                      (64, 16, 256, 1024)], ids=str)
def test_decode_scratch_holds_every_partial(b, h, dh, s):
    """The kernel writes (m, l) at (head * nsplit + split) * 2 and the
    unnormalised row at the acc base (b * h * nsplit * 2) + (head * nsplit
    + split) * dh, for every query head of every batch row."""
    rows, splits = da_ops.decode_split(b, h, s, H100_SMS)
    floats = da_ops.partial_floats(b, h, dh, splits)
    if splits == 1:
        assert floats == 0  # one split writes its output directly
        return
    heads = b * h
    last_ml = ((heads - 1) * splits + splits - 1) * 2 + 1
    last_acc = heads * splits * 2 + ((heads - 1) * splits + splits - 1) * dh + dh - 1
    assert max(last_ml, last_acc) < floats


FLASH_CASES = [  # b, h, sq, sk, causal, q_offset, kv_len
    (1, 16, 128, 1024, True, 512, 640),     # OLMo-1B's prefill chunk
    (1, 16, 128, 1024, True, 0, 128),
    (1, 16, 128, 1024, True, 128, 256),
    (4, 16, 128, 1024, True, 512, "ragged"),
    (1, 16, 2048, 2048, True, 0, None),     # forward at S = 2048
    (1, 64, 128, 1024, True, 512, 640),     # qwen3-32b's GQA widths
    (3, 4, 70, 200, True, 37, None),
    (3, 4, 70, 200, False, 130, 0),
    (1, 8, 1, 1024, True, 1023, None),
    (2, 2, 2048, 1024, False, 0, None),
]


def _span(sq, sk, causal, q_offset, kv_len):
    lens = None if kv_len in (None, "ragged") else kv_len
    return fa_ops.key_span(sq, sk, causal=causal, q_offset=q_offset, kv_len=lens)


@pytest.mark.parametrize("b,h,sq,sk,causal,q_offset,kv_len", FLASH_CASES, ids=str)
def test_flash_split_covers_every_key_once(b, h, sq, sk, causal, q_offset, kv_len):
    span = _span(sq, sk, causal, q_offset, kv_len)
    rows_a_block, keys, splits = fa_ops.flash_split(b, h, sq, span, H100_SMS)
    assert rows_a_block in (64, 128)
    assert keys > 0 and keys % TILE == 0
    assert keys * splits >= span  # the kernel refuses a split that does not cover the span
    assert (splits - 1) * keys < max(span, 1)  # no split empty by construction
    # each query tile sees keys [0, hi), hi at most the span; its live
    # splits cover them once
    for qt in range(-(-sq // rows_a_block)):
        rows = min(rows_a_block, sq - qt * rows_a_block)
        for n in {span, span // 2, 0}:
            hi = min(n, max(q_offset + qt * TILE + rows, 0)) if causal else n
            ranges = _live_splits(hi, keys)
            assert len(ranges) <= splits
            assert [k for lo, up in ranges for k in range(lo, up)] == list(range(hi))


@pytest.mark.parametrize("b,h,sq,sk,causal,q_offset,kv_len", FLASH_CASES, ids=str)
def test_flash_split_fills_the_card(b, h, sq, sk, causal, q_offset, kv_len):
    span = _span(sq, sk, causal, q_offset, kv_len)
    rows, keys, splits = fa_ops.flash_split(b, h, sq, span, H100_SMS)
    tiles = max(1, -(-span // TILE))
    if b * h * -(-sq // 128) >= H100_SMS:
        assert (rows, splits) == (128, 1)  # 128-row query tiles already fill the card
    else:
        assert rows == 64
        blocks = b * h * -(-sq // 64)
        assert blocks * splits <= H100_SMS  # at most one block an SM
        want = min(tiles, H100_SMS // blocks)
        assert 2 * splits > want  # at least half way to the most splits that fit


def test_flash_split_at_the_main_shapes():
    assert fa_ops.flash_split(1, 16, 128, 640, H100_SMS) == (64, 192, 4)  # the prefill chunk
    assert fa_ops.flash_split(1, 64, 128, 640, H100_SMS) == (64, 640, 1)  # its GQA widths
    assert fa_ops.flash_split(1, 16, 2048, 2048, H100_SMS) == (128, 2048, 1)  # forward


@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("b,h,sq,dh,splits", [(1, 16, 128, 128, 5), (4, 16, 128, 128, 2),
                                              (3, 4, 70, 32, 4), (1, 8, 1, 64, 3)], ids=str)
def test_flash_scratch_holds_every_partial(b, h, sq, dh, splits, rows):
    """The kernel writes (m, l) for the block's rows at part * 2 * rows and
    the accumulator, (dh / 8) float4 chunks for each of its 2 * rows
    consumer threads, at the acc base (parts * 2 * rows floats) + part *
    rows * dh, for every part = (query tile id) * splits + split."""
    floats = fa_ops.partial_floats(b, h, sq, dh, splits, rows)
    parts = b * h * -(-sq // rows) * splits
    threads = 2 * rows
    last_ml = (parts - 1) * 2 * rows + 2 * rows - 1
    last_acc = (parts * 2 * rows + ((parts - 1) * (dh // 8) + dh // 8 - 1) * threads * 4
                + (threads - 1) * 4 + 3)
    assert max(last_ml, last_acc) < floats
    assert fa_ops.partial_floats(b, h, sq, dh, 1, rows) == 0


@pytest.mark.parametrize("sq,sk,causal,q_offset,kv_len,want", [
    (128, 1024, True, 512, 640, 640),
    (128, 1024, True, 512, None, 640),
    (128, 1024, True, 512, 600, 600),
    (128, 1024, False, 512, None, 1024),
    (128, 1024, False, 0, 2000, 1024),
    (128, 1024, True, -200, None, 0),
    (70, 200, True, 0, -3, 0),
])
def test_key_span(sq, sk, causal, q_offset, kv_len, want):
    assert fa_ops.key_span(sq, sk, causal=causal, q_offset=q_offset, kv_len=kv_len) == want
