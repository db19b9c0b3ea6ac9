"""The CUDA kernels of repro_torch against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports neither jax nor the JAX package, so that it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Shapes are small and odd on purpose (S not a multiple of the kernel's
64-row tile, V not a multiple of its vocab tile, B above its 8-row batch
chunk); chip_smoke.py covers the full widths.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.kernels.decode_attention.ops import fused_decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.emit_norm_logits.ops import emit_norm_logits
from repro_torch.kernels.emit_norm_logits.ref import emit_norm_logits_ref
from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_bhsd
from repro_torch.kernels.flash_attention.ref import attention_ref, flash_attention_ref
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.ssd.ops import ssd_chunked_cuda, ssd_intra_chunk
from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref, ssd_ref

pytestmark = pytest.mark.cuda

DTYPES = [torch.bfloat16, torch.float32]
# Decode attention: one rounding of order-1 outputs to the output dtype,
# moved by fp32 differences between the online and the two-pass softmax:
# bf16 2 ulps at magnitude 1; fp32 sums of up to 100 terms in another order.
DECODE_TOL = {torch.bfloat16: 1.6e-2, torch.float32: 1e-5}


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    K.reset_launches()


def _gen(seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


def _capture(fn, stream=None):
    """A CUDA graph of ``fn`` and its output: ``fn`` runs once on the
    capture stream first, which reserves the attention kernels' merge
    tickets for the capture (none is allocated while capturing)."""
    stream = stream or torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = fn()
    return graph, out


def _decode_args(gen, b, s, h, kv, dh, dtype, pos):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    return (rnd(b, 1, h, dh), rnd(b, kv, dh), rnd(b, kv, dh), rnd(b, s, kv, dh),
            rnd(b, s, kv, dh)), pos, pos + 1


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("h,kv,dh", [(4, 4, 128), (16, 2, 128), (8, 4, 64), (12, 12, 32)])
def test_decode_attention_matches_plain(dtype, h, kv, dh):
    s = 100
    args, pos, kv_len = _decode_args(_gen(0), 4, s, h, kv, dh, dtype, [0, s - 1, 63, 64])
    got = fused_decode_attention(*args, pos=pos, kv_len=kv_len)
    want = decode_attention_ref(*args, pos=pos, kv_len=kv_len)
    tol = DECODE_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert K.LAUNCHES["decode_attention"] == 1


def test_decode_attention_edges():
    """kv_len 0 yields 0 (the NaN scrub); rows beyond kv_len are never
    read (NaN there leaves the output finite); the cache is not written."""
    args, pos, _ = _decode_args(_gen(1), 3, 70, 4, 2, 64, torch.float32, [5, 0, 69])
    args[3][0, 6:] = float("nan")
    args[4][0, 6:] = 1e4
    before = args[3].clone()
    kv_len = torch.tensor([6, 0, 70], dtype=torch.int32, device="cuda")
    got = fused_decode_attention(*args, pos=pos, kv_len=kv_len)
    want = decode_attention_ref(*args, pos=pos, kv_len=kv_len)
    assert torch.isfinite(got).all() and torch.all(got[1] == 0)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert torch.equal(args[3].isnan(), before.isnan())


def test_wrappers_raise_rather_than_fall_back():
    args, pos, kv_len = _decode_args(_gen(2), 2, 16, 4, 2, 64, torch.float32, [1, 2])
    q = args[0].transpose(2, 3).contiguous().transpose(2, 3)  # same values, not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        fused_decode_attention(q, *args[1:], pos=pos, kv_len=kv_len)
    with pytest.raises(TypeError):
        fused_decode_attention(*args, pos=pos.long(), kv_len=kv_len)
    x = torch.zeros(2, 1, 64, device="cuda")
    with pytest.raises(TypeError):
        emit_norm_logits(x, torch.zeros(64, 96, device="cuda", dtype=torch.bfloat16),
                         norm="layernorm_nonparam")
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(*(torch.zeros(1, 8, 2, 48, device="cuda") for _ in range(3)), causal=True)
    q = torch.zeros(1, 8, 2, 64, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), q, q, causal=True)
    with pytest.raises(TypeError):
        flash_attention(q, q.bfloat16(), q.bfloat16(), causal=True)
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half(), causal=True)
    with pytest.raises(TypeError, match="q_offset"):
        flash_attention(q, q, q, causal=True, q_offset=torch.tensor(3))
    with pytest.raises(ValueError, match="on"):
        flash_attention(q, q.cpu(), q.cpu(), causal=True)
    with pytest.raises(TypeError, match="int32"):
        flash_attention(q, q, q, causal=True, kv_len=torch.tensor([3], device="cuda"))
    assert K.LAUNCHES == {"decode_attention": 0, "emit_norm_logits": 0, "attention": 0,
                          "ssd": 0, "rmsnorm": 0}


def _split_positions(b, s, rows):
    """Write positions at tile and split edges (rows = the split's rows),
    one per batch row, cycling."""
    edges = [0, 63, 64, rows - 1, rows, rows + 1, 2 * rows - 1, s - 1, s // 2, 127, 128, 1]
    return [min(edges[i % len(edges)], s - 1) for i in range(b)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("dh", [32, 64, 128, 256])
@pytest.mark.parametrize("g,kv", [(1, 4), (6, 2), (8, 2), (16, 2)], ids=str)
@pytest.mark.parametrize("b", [1, 8, 64])
@pytest.mark.parametrize("s", [1000, 1024])
def test_decode_attention_splits_match_plain(dtype, dh, g, kv, b, s):
    """The split grid at every served width: positions at tile and split
    edges; row 0 is an admission (pos 0) over a poisoned cache (NaN in K
    and 1e4 in V past kv_len: masked, never multiplied in)."""
    from repro_torch.kernels.decode_attention.ops import decode_split

    h = g * kv
    rows, splits = decode_split(b, kv, s, torch.cuda.get_device_properties(0).multi_processor_count)
    args, pos, kv_len = _decode_args(_gen(10), b, s, h, kv, dh, dtype, _split_positions(b, s, rows))
    args[3][0, 1:] = float("nan")
    args[4][0, 1:] = 1e4
    got = fused_decode_attention(*args, pos=pos, kv_len=kv_len)
    want = decode_attention_ref(*args, pos=pos, kv_len=kv_len)
    assert torch.isfinite(got.float()).all()
    tol = DECODE_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert K.LAUNCHES["decode_attention"] == 1


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_decode_attention_twice_and_in_a_graph(dtype):
    """The merge tickets are back at 0 after every launch: two calls in a
    row, then one capture replayed twice on new inputs, all match."""
    b, s, h, kv, dh = 8, 1024, 16, 16, 128
    pos = [1023, 517, 128, 64, 900, 1000, 3, 0]
    cases = [_decode_args(_gen(11 + i), b, s, h, kv, dh, dtype, pos) for i in range(3)]
    tol = DECODE_TOL[dtype]
    for args, pos, kv_len in cases[:2]:
        got = fused_decode_attention(*args, pos=pos, kv_len=kv_len)
        want = decode_attention_ref(*args, pos=pos, kv_len=kv_len)
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    static = [t.clone() for t in cases[0][0]], cases[0][1].clone(), cases[0][2].clone()
    graph, out = _capture(lambda: fused_decode_attention(*static[0], pos=static[1],
                                                         kv_len=static[2]))
    for args, pos, kv_len in cases[1:]:
        for dst, src in zip(static[0] + [static[1], static[2]], list(args) + [pos, kv_len]):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        want = decode_attention_ref(*args, pos=pos, kv_len=kv_len)
        torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm_nonparam"])
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("b", [1, 8, 11, 16])
@pytest.mark.parametrize("v", [64, 1000, 50280, 50288, 50304, 163840])
@pytest.mark.parametrize("d", [256, 2048, 2080])
def test_emit_matches_plain(dtype, norm, tied, b, v, d):
    """V 64: fewer groups (8 vocab rows tied, 64 columns untied) than the
    rings have blocks; 1000, 50280 and 50288: shares of the vocab that
    differ by a group between blocks, and (untied) a last group of 64
    columns cut short, TMA zero-filling the rest; 50304, 50280 and 163840:
    the served widths.  d 2080: a row group (tied) takes two stages, the
    second of 32 of d's columns; untied, the last stage is ragged and its
    rows past d are zero-filled."""
    _check_emit(dtype, norm, tied, b, v, d)


_TIED_TILES = [(17, 256), (33, 256), (48, 256), (64, 256), (17, 2048), (33, 2048), (48, 2048)]


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm_nonparam"])
@pytest.mark.parametrize("v", [64, 1000, 50280, 50304, 163840])
@pytest.mark.parametrize("dtype,tied,b,d", [
    *[pytest.param(torch.bfloat16, True, b, d, id=f"bf16-tied-{b}-{d}") for b, d in _TIED_TILES],
    *[pytest.param(dt, False, b, d, id=f"{str(dt)[6:]}-untied-{b}-{d}")
      for dt in DTYPES for b in (17, 33, 48, 64) for d in (256, 2048, 2080)],
])
def test_emit_batch_tiles_match_plain(norm, v, dtype, tied, b, d):
    """Past 16 batch rows.  The tied bf16 kernel: two to four 16-row batch
    tiles, the last one partial except at 64; at d 2048, 33 and 48 rows
    leave room only for stages narrower than a row.  The untied kernel:
    three to eight n8 tiles (bf16) or rows held (fp32), and where the
    normalised x does not fit beside two stages (bf16 64 x 2048, fp32
    33 x 2048 and up) the batch split over launches."""
    _check_emit(dtype, norm, tied, b, v, d)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d,v", [(5120, 151936), (8192, 128256), (1536, 2048)], ids=str)
def test_emit_untied_zoo_heads_match_plain(dtype, d, v):
    """The untied heads of the zoo at B 8: qwen3-32b's (and llama4's d),
    llama-3.2-vision's d 8192 (three stages beside x in bf16; fp32 splits
    the batch over two launches) and musicgen's V 2048 (32 groups: 32 of
    the card's SMs busy)."""
    _check_emit(dtype, "rmsnorm", False, 8, v, d)


def test_emit_untied_refuses_what_does_not_fit():
    """A row of x too wide for two stages beside it (a batch past 64 rows
    is tiled over launches: test_emit_wide_batches_tile_over_launches)."""
    x = torch.zeros(1, 1, 120000, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no room"):
        emit_norm_logits(x, torch.zeros(120000, 64, device="cuda", dtype=torch.bfloat16),
                         norm="layernorm_nonparam")
    assert K.LAUNCHES["emit_norm_logits"] == 0


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("b,d,v", [(8, 2048, 163840), (33, 2080, 50280)], ids=str)
def test_emit_untied_in_a_graph(dtype, b, d, v):
    """The untied launch (two launches for fp32 at 33 x 2080) captured in
    a CUDA graph, replayed on new inputs copied into its static buffers:
    every replay holds to the plain version."""
    cases = [_emit_case(_gen(20 + i), dtype, False, b, v, d) for i in range(3)]
    static = [t.clone() for t in cases[0]]
    kw = dict(norm="rmsnorm", tied=False)
    graph, out = _capture(lambda: emit_norm_logits(static[0], static[1], scale=static[2], **kw))
    for x, w, scale in cases[1:]:
        for dst, src in zip(static, (x, w, scale)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        _assert_emit_close(out, emit_norm_logits_ref(x, w, scale=scale, **kw), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("b", [49, 65, 128, 256])
def test_emit_wide_batches_tile_over_launches(dtype, tied, b):
    """Past the rows one launch holds (tied: what fits shared memory, 48
    bf16 rows at d 2048; untied: 64), the batch is tiled over launches
    (``emit_tiles``), each writing its rows of the one output: every row
    holds to the plain version, and the launches are the plan's."""
    from repro_torch.kernels.emit_norm_logits.ops import emit_tiles

    d, v = 2048, 50304
    x, w, scale = _emit_case(_gen(4), dtype, tied, b, v, d)
    kw = dict(norm="rmsnorm", tied=tied, scale=scale)
    got = emit_norm_logits(x, w, **kw)
    _assert_emit_close(got, emit_norm_logits_ref(x, w, **kw), dtype)
    assert K.LAUNCHES["emit_norm_logits"] == len(emit_tiles(b, d, dtype, tied))


def _emit_case(gen, dtype, tied, b, v, d):
    x = (torch.randn((b, 1, d), generator=gen, device="cuda") * 2 + 0.3).to(dtype)
    w = (torch.randn((v, d) if tied else (d, v), generator=gen, device="cuda") * d**-0.5).to(dtype)
    scale = torch.randn((d,), generator=gen, device="cuda") * 0.2 + 1.0
    return x, w, scale


def _assert_emit_close(got, want, dtype):
    # bf16: 2 bf16 ulps of the row's largest |logit| (an element of the
    # normalised x may round one ulp apart); fp32: 1e-4 of it.
    top = want.abs().amax(-1, keepdim=True)
    allowed = (2 * torch.exp2(torch.floor(torch.log2(top)) - 7)
               if dtype == torch.bfloat16 else 1e-4 * top)
    assert ((got - want).abs() <= allowed).all()
    assert torch.equal(got, got.to(dtype).float())  # logits rounded to x's dtype


def _check_emit(dtype, norm, tied, b, v, d):
    x, w, scale = _emit_case(_gen(3), dtype, tied, b, v, d)
    kw = dict(norm=norm, tied=tied, scale=scale if norm == "rmsnorm" else None)
    got = emit_norm_logits(x, w, **kw)
    want = emit_norm_logits_ref(x, w, **kw)
    _assert_emit_close(got, want, dtype)
    assert K.LAUNCHES["emit_norm_logits"] == 1


def test_decode_step_kernels_match_plain():
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    cfg = get_config("qwen3-32b").with_overrides(
        num_layers=2, d_model=512, num_heads=8, num_kv_heads=2, d_ff=1024, vocab_size=1024)
    params = init_params(T.model_layout(cfg), seed=0, device="cuda")
    cache = T.init_cache(cfg, 4, 96, device="cuda")
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(1, 1024, size=(4, 64)), device="cuda")
    T.prefill_step(params, cache, cfg, tokens=toks, pos=0)
    tokens = torch.as_tensor(rng.integers(1, 1024, size=4), device="cuda")
    lengths = torch.tensor([64, 10, 0, 63], dtype=torch.int32, device="cuda")
    copy = {n: {k: t.clone() for k, t in blk.items()} for n, blk in cache.items()}
    got, c_got = T.decode_step(params, cache, cfg, tokens=tokens, lengths=lengths)
    want, c_want = T.decode_step(params, copy, cfg, tokens=tokens, lengths=lengths,
                                 kernels="plain")
    # the block pre-norms (2 a layer) of the prefill and of the decode step
    assert K.LAUNCHES == {"decode_attention": 2, "emit_norm_logits": 1, "attention": 0,
                          "ssd": 0, "rmsnorm": 8}
    top = want.abs().amax(-1, keepdim=True)
    assert ((got - want).abs() <= 4 * torch.exp2(torch.floor(torch.log2(top)) - 7)).all()
    # the row written at each position is the same on both paths (layer 0)
    idx = torch.arange(4, device="cuda")
    for key in ("k", "v"):
        torch.testing.assert_close(c_got["block0"][key][0, idx, lengths.long()],
                                   c_want["block0"][key][0, idx, lengths.long()])


# Flash attention: outputs are convex combinations of order-1 values.
# bf16: P is rounded to bf16 for P.V on the tensor cores (the plain
# version keeps it in fp32), then the output is rounded once: JAX's own
# tolerance for its flash kernel, 2e-2.  fp32: sums of up to 200 terms in
# another order, 2e-5 (also JAX's).
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}


def _flash_args(gen, b, sq, sk, h, kv, dh, dtype):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return rnd(b, sq, h, dh), rnd(b, sk, kv, dh), rnd(b, sk, kv, dh)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("h,kv,dh", [(4, 4, 128), (8, 2, 64), (6, 3, 32)])
@pytest.mark.parametrize("q_offset", [0, 37, 130])
@pytest.mark.parametrize("kv_len", ["none", "int", "ragged"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_plain(dtype, h, kv, dh, q_offset, kv_len, causal):
    """Sq = 70 query rows (not a multiple of the 64-row tile) at q_offset
    over a 200-row cache; kv_len none, one count, or ragged with a 0."""
    b, sq, sk = 3, 70, 200
    q, k, v = _flash_args(_gen(4), b, sq, sk, h, kv, dh, dtype)
    lens = {"none": None, "int": q_offset + sq,
            "ragged": torch.tensor([q_offset + sq, 0, 65], dtype=torch.int32, device="cuda")}[kv_len]
    kw = dict(causal=causal, q_offset=q_offset, kv_len=lens)
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=FLASH_TOL[dtype], rtol=FLASH_TOL[dtype])
    assert K.LAUNCHES["attention"] == 1
    if kv_len == "ragged":
        assert torch.all(got[1] == 0)  # no valid key: 0, the NaN scrub


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("sq", [1, 70, 128, 2048])
@pytest.mark.parametrize("h,kv", [(16, 16), (16, 2)], ids=str)
@pytest.mark.parametrize("q_offset,kv_len", [
    (500, None),                   # the causal bound inside a split
    (512, [640, 0, 100, 1024]),    # a row with no key; rows whose later splits are empty
    (0, 1024),
], ids=str)
def test_flash_attention_splits_match_plain(dtype, sq, h, kv, q_offset, kv_len):
    """Sk = 1024 split over blocks (a 128-row chunk gives several splits),
    causal; GQA with g = 8."""
    b, sk, dh = (4 if isinstance(kv_len, list) else 1), 1024, 128
    if sq == 2048:
        sk, q_offset = 2048, 0
    q, k, v = _flash_args(_gen(12), b, sq, sk, h, kv, dh, dtype)
    lens = (torch.tensor(kv_len, dtype=torch.int32, device="cuda") if isinstance(kv_len, list)
            else kv_len)
    kw = dict(causal=True, q_offset=q_offset, kv_len=lens)
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=FLASH_TOL[dtype], rtol=FLASH_TOL[dtype])
    if isinstance(kv_len, list):
        assert torch.all(got[1] == 0)  # no valid key: 0
    assert K.LAUNCHES["attention"] == 1


def test_flash_attention_twice_and_in_a_graph():
    """The merge tickets are back at 0 after every launch (bf16 splits)."""
    b, sq, sk, h, kv, dh = 1, 128, 1024, 16, 16, 128
    kw = dict(causal=True, q_offset=512, kv_len=640)
    cases = [_flash_args(_gen(13 + i), b, sq, sk, h, kv, dh, torch.bfloat16) for i in range(3)]
    tol = FLASH_TOL[torch.bfloat16]
    for q, k, v in cases[:2]:
        torch.testing.assert_close(flash_attention(q, k, v, **kw).float(),
                                   flash_attention_ref(q, k, v, **kw).float(), atol=tol, rtol=tol)
    static = [t.clone() for t in cases[0]]
    graph, out = _capture(lambda: flash_attention(*static, **kw))
    for case in cases[1:]:
        for dst, src in zip(static, case):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), flash_attention_ref(*case, **kw).float(),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("sq,q_offset,kv_len", [(128, 512, 640), (128, 896, None),
                                                 (70, 500, None), (2048, 0, None)])
def test_flash_attention_is_repeatable(sq, q_offset, kv_len):
    """The same inputs give the same bits, call after call: the last split
    of a query tile sums every split's partial in split order, whichever
    split finished last.  (Temperature sampling's reproducibility rests
    on it: a one-ulp change of a logit can change a drawn token.)"""
    sk = 2048 if sq == 2048 else 1024
    q, k, v = _flash_args(_gen(21), 1, sq, sk, 16, 16, 128, torch.bfloat16)
    kw = dict(causal=True, q_offset=q_offset, kv_len=kv_len)
    first = flash_attention(q, k, v, **kw)
    for _ in range(20):
        assert torch.equal(flash_attention(q, k, v, **kw), first)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_decode_attention_is_repeatable(dtype):
    args, pos, kv_len = _decode_args(_gen(22), 8, 1024, 16, 16, 128, dtype,
                                     [0, 1023, 517, 128, 64, 900, 1000, 3])
    first = fused_decode_attention(*args, pos=pos, kv_len=kv_len)
    for _ in range(20):
        assert torch.equal(fused_decode_attention(*args, pos=pos, kv_len=kv_len), first)


def test_attention_on_two_streams_at_once():
    """Decode attention on one stream and flash attention on another, many
    launches of each in flight together: each stream has its own merge
    tickets, so every split merges right."""
    dec = _decode_args(_gen(21), 8, 1024, 16, 16, 128, torch.bfloat16,
                       [1023, 517, 128, 64, 900, 1000, 3, 0])
    fl = _flash_args(_gen(22), 1, 128, 1024, 16, 16, 128, torch.bfloat16)
    fkw = dict(causal=True, q_offset=512, kv_len=640)
    want_d = decode_attention_ref(*dec[0], pos=dec[1], kv_len=dec[2])
    want_f = flash_attention_ref(*fl, **fkw)
    streams = torch.cuda.Stream(), torch.cuda.Stream()
    outs = [], []
    for _ in range(3):
        for st in streams:
            st.wait_stream(torch.cuda.current_stream())
        for _ in range(40):
            with torch.cuda.stream(streams[0]):
                outs[0].append(fused_decode_attention(*dec[0], pos=dec[1], kv_len=dec[2]))
            with torch.cuda.stream(streams[1]):
                outs[1].append(flash_attention(*fl, **fkw))
        torch.cuda.synchronize()
    tol = DECODE_TOL[torch.bfloat16]
    for got in outs[0]:
        torch.testing.assert_close(got.float(), want_d.float(), atol=tol, rtol=tol)
    tol = FLASH_TOL[torch.bfloat16]
    for got in outs[1]:
        torch.testing.assert_close(got.float(), want_f.float(), atol=tol, rtol=tol)
    keys = [(torch.device("cuda", torch.cuda.current_device()), st.cuda_stream) for st in streams]
    assert K._TICKETS[keys[0]] is not K._TICKETS[keys[1]]
    assert K.LAUNCHES["decode_attention"] == K.LAUNCHES["attention"] == 120


def test_captured_decode_attention_survives_ticket_growth():
    """A graph of decode attention keeps working after a larger flash call
    on its stream replaces the stream's ticket buffer and the capture
    reserve the graph's tickets lie in: both old buffers are kept alive,
    so the memory the graph points at is never handed out again (here, to
    tensors full of 1 allocated right after)."""
    b, s, h, kv, dh = 8, 1024, 16, 16, 128
    pos = [1023, 517, 128, 64, 900, 1000, 3, 0]
    cases = [_decode_args(_gen(31 + i), b, s, h, kv, dh, torch.bfloat16, pos) for i in range(2)]
    static = [t.clone() for t in cases[0][0]], cases[0][1].clone(), cases[0][2].clone()
    stream = torch.cuda.Stream()
    graph, out = _capture(lambda: fused_decode_attention(*static[0], pos=static[1],
                                                         kv_len=static[2]), stream)
    device = torch.device("cuda", torch.cuda.current_device())
    old = K._TICKETS[device, stream.cuda_stream]
    reserve = K._CAPTURE_RESERVE[device][0]
    # 4 x 16 query heads x 65 tiles of 64 rows: 4160 tickets, more than the
    # first 4096 and than the reserve keeps room for
    q, k, v = (torch.randn(shape, generator=_gen(33), device="cuda")
               for shape in ((4, 4160, 16, 32), (4, 64, 16, 32), (4, 64, 16, 32)))
    with torch.cuda.stream(stream):
        flash_attention(q, k, v, causal=False)
        junk = [torch.full_like(t, 1) for t in (old, reserve) for _ in range(8)]
    torch.cuda.synchronize()
    assert K._TICKETS[device, stream.cuda_stream].numel() > old.numel()
    assert K._CAPTURE_RESERVE[device][0] is not reserve
    assert any(t is old for t in K._RETIRED) and any(t is reserve for t in K._RETIRED)
    args, p, n = cases[1]
    for dst, src in zip(static[0] + [static[1], static[2]], list(args) + [p, n]):
        dst.copy_(src)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        want = decode_attention_ref(*args, pos=p, kv_len=n)
        tol = DECODE_TOL[torch.bfloat16]
        torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    assert torch.all(old == 0) and torch.all(reserve == 0)
    del junk


def test_graphs_captured_on_one_stream_replay_on_two_streams():
    """Two graphs of decode attention captured on one stream, replayed at
    once on two other streams, many times, while eager decode attention
    runs on the capture stream: each captured launch has tickets of its
    own, so every split merges right."""
    b, s, h, kv, dh = 8, 1024, 16, 16, 128
    pos = [1023, 517, 128, 64, 900, 1000, 3, 0]
    cases = [_decode_args(_gen(41 + i), b, s, h, kv, dh, torch.bfloat16, pos) for i in range(3)]
    capture = torch.cuda.Stream()
    graphs = [_capture(lambda args=args, p=p, n=n: fused_decode_attention(
        *args, pos=p, kv_len=n), capture) for args, p, n in cases[:2]]
    wants = [decode_attention_ref(*args, pos=p, kv_len=n) for args, p, n in cases]
    replay = torch.cuda.Stream(), torch.cuda.Stream()
    eager = []
    for st in replay:
        st.wait_stream(torch.cuda.current_stream())
    capture.wait_stream(torch.cuda.current_stream())
    for _ in range(40):
        for (graph, _), st in zip(graphs, replay):
            with torch.cuda.stream(st):
                graph.replay()
        with torch.cuda.stream(capture):
            args, p, n = cases[2]
            eager.append(fused_decode_attention(*args, pos=p, kv_len=n))
    torch.cuda.synchronize()
    tol = DECODE_TOL[torch.bfloat16]
    for (_, out), want in zip(graphs, wants):
        torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    for got in eager:
        torch.testing.assert_close(got.float(), wants[2].float(), atol=tol, rtol=tol)
    assert K.LAUNCHES["decode_attention"] == 2 * 2 + 40  # warm-ups, captures, eager calls


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_flash_attention_bhsd_and_poisoned_cache(dtype):
    """The (B, H, S, dh) entry; rows past kv_len are never read: NaN in K
    there (masked before the softmax) and 1e4 in V (multiplied by an
    exact 0 in the plain version, which a NaN would turn into NaN)."""
    b, h, kv, sq, sk, dh = 2, 8, 2, 96, 160, 64
    q, k, v = _flash_args(_gen(5), b, sq, sk, h, kv, dh, dtype)
    lens = torch.tensor([100, 31], dtype=torch.int32, device="cuda")
    for i, n in enumerate(lens.tolist()):
        k[i, n:] = float("nan")
        v[i, n:] = 1e4
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    got = flash_attention_bhsd(qt, kt, vt, causal=True, q_offset=4, kv_len=lens)
    want = attention_ref(qt, kt, vt, causal=True, q_offset=4, kv_len=lens)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=FLASH_TOL[dtype], rtol=FLASH_TOL[dtype])
    torch.testing.assert_close(flash_attention(q, k, v, causal=True, q_offset=4, kv_len=lens),
                               got.transpose(1, 2), atol=0, rtol=0)
    assert K.LAUNCHES["attention"] == 2


def test_prefill_flash_matches_plain():
    """Two prefill chunks (the second a padded ragged tail) through the
    flash kernel against the same chunks with its plain version."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    cfg = get_config("qwen3-32b").with_overrides(
        num_layers=2, d_model=512, num_heads=8, num_kv_heads=2, d_ff=1024, vocab_size=1024,
        dtype=torch.float32)
    params = init_params(T.model_layout(cfg), seed=0, device="cuda")
    rng = np.random.default_rng(1)
    caches = [T.init_cache(cfg, 1, 160, device="cuda") for _ in range(2)]
    for pos, at in ((0, None), (64, 40)):
        toks = torch.as_tensor(rng.integers(1, 1024, size=(1, 64)), device="cuda")
        got, _ = T.prefill_step(params, caches[0], cfg, tokens=toks, pos=pos,
                                attn_impl="flash", logits_at=at)
        want, _ = T.prefill_step(params, caches[1], cfg, tokens=toks, pos=pos,
                                 attn_impl="flash", logits_at=at, kernels="plain")
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert K.LAUNCHES == {"decode_attention": 0, "emit_norm_logits": 0, "attention": 4,
                          "ssd": 0, "rmsnorm": 8}


# SSD intra-chunk kernel.  fp32: sums of up to 256 products in another
# order, and the chunk's cumsum scanned in another order (the exponent
# of each decay moves by a few fp32 ulps of |cum| <= ~40): 1e-4.  bf16
# y: the same fp32 value rounded once to bf16, which one fp32 ulp can
# move by one bf16 ulp: 2 bf16 ulps at magnitude 1, 1.6e-2.
SSD_Y_TOL = {torch.bfloat16: 1.6e-2, torch.float32: 1e-4}


def _ssd_args(gen, bc, h, q, p, g, n, dtype):
    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    x = rnd(bc, h, q, p)
    dt = torch.rand((bc, h, q), generator=gen, device="cuda") * 0.19 + 0.01
    b, c = rnd(bc, g, q, n, scale=n**-0.5), rnd(bc, g, q, n, scale=n**-0.5)
    a = -(torch.rand((h,), generator=gen, device="cuda") + 0.5)
    d_skip = torch.randn((h,), generator=gen, device="cuda")
    return x, dt, b, c, a, d_skip


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("bc,h,q,p,g,n", [
    (2, 8, 256, 64, 1, 128),   # Mamba2-1.3B's widths, a full chunk
    (3, 4, 37, 64, 1, 128),    # a ragged tail
    (1, 8, 100, 32, 4, 48),    # G = 4, N not a multiple of the 16-deep step
    (2, 4, 1, 80, 2, 40),      # one row; P over two column tiles
    (1, 2, 130, 130, 1, 200),  # every edge ragged
    (1, 8, 1, 64, 1, 128),     # Q = 1, 16, 64, 65, 255: one row; one k step; one tile;
    (1, 8, 16, 64, 1, 128),    #   a second tile of one row; every tile, the last ragged
    (1, 8, 64, 64, 1, 128),
    (1, 8, 65, 64, 1, 128),
    (1, 8, 255, 64, 1, 128),
    (2, 8, 256, 64, 2, 64),    # G = 2, N = 64
], ids=str)
def test_ssd_intra_chunk_matches_plain(dtype, bc, h, q, p, g, n):
    args = _ssd_args(_gen(6), bc, h, q, p, g, n, dtype)
    y, state, cum = ssd_intra_chunk(*args)
    wy, wstate, wcum = ssd_intra_chunk_ref(*args)
    assert y.dtype == dtype and state.dtype == cum.dtype == torch.float32
    tol = SSD_Y_TOL[dtype]
    torch.testing.assert_close(y.float(), wy.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, wstate, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(cum, wcum, atol=1e-5, rtol=1e-5)
    assert K.LAUNCHES["ssd"] == 1


@pytest.mark.parametrize("recurrence", ["scan", "associative"])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 128, 4, 64, 1, 128, 32), (1, 256, 8, 64, 2, 64, 64), (1, 512, 8, 64, 1, 128, 256),
], ids=str)
def test_ssd_chunked_cuda_matches_the_recurrence(recurrence, b, s, h, p, g, n, chunk):
    """The chunked SSD through the kernel against the naive recurrence
    (2e-3, as the JAX package holds its Pallas kernel) and against the
    plain chunked form (1e-4), with an initial state."""
    from repro_torch.models.ssm import ssd_chunked

    gen = _gen(7)
    x = torch.randn((b, s, h, p), generator=gen, device="cuda")
    dt = torch.rand((b, s, h), generator=gen, device="cuda") * 0.19 + 0.01
    a = -(torch.rand((h,), generator=gen, device="cuda") + 0.5)
    bm = torch.randn((b, s, g, n), generator=gen, device="cuda") * n**-0.5
    cm = torch.randn((b, s, g, n), generator=gen, device="cuda") * n**-0.5
    d_skip = torch.randn((h,), generator=gen, device="cuda")
    s0 = torch.randn((b, h, n, p), generator=gen, device="cuda")
    y, final = ssd_chunked_cuda(x, dt, a, bm, cm, d_skip, chunk=chunk, initial_state=s0,
                                recurrence=recurrence)
    ry, rfinal = ssd_ref(x, dt, a, bm, cm, d_skip, initial_state=s0)
    torch.testing.assert_close(y, ry, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(final, rfinal, atol=2e-3, rtol=2e-3)
    py, pfinal = ssd_chunked(x, dt, a, bm, cm, d_skip, chunk=chunk, initial_state=s0)
    torch.testing.assert_close(y, py, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(final, pfinal, atol=1e-4, rtol=1e-4)
    assert K.LAUNCHES["ssd"] == 1


# RMSNorm: the same fp32 value rounded once to x's dtype; the fp32 sum of
# squares in another order and rsqrtf move it by an fp32 ulp or two,
# which can move the bf16 rounding by one bf16 ulp (2**-7 relative).
RMS_TOL = {torch.bfloat16: dict(atol=1e-5, rtol=2**-7), torch.float32: dict(atol=1e-6, rtol=1e-5)}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(8, 4096), (256, 4096), (8, 2048), (256, 2048), (2, 3, 40),
                                   (1, 1, 8), (7, 8192), (3, 16384), (5, 520)], ids=str)
def test_rmsnorm_matches_plain(dtype, shape):
    """d 8192 at the one-pass path's 512 threads; d 16384, 520 and 40 on
    the looped path."""
    gen = _gen(8)
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.3).to(dtype)
    scale = torch.randn((shape[-1],), generator=gen, device="cuda") * 0.2 + 1
    got = rmsnorm(x, scale, 1e-5)
    want = rmsnorm_ref(x, scale, 1e-5)
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), **RMS_TOL[dtype])
    assert K.LAUNCHES["rmsnorm"] == 1


def _gate(gen, shape, dtype, width=None):
    """z as ssm_block hands it over: the first d columns of a wider row
    (an in_proj output of ``width`` columns, Mamba2's 2 d + 2 N + H)."""
    d = shape[-1]
    width = width or 2 * d + 2 * 128 + max(d // 64, 8)
    proj = (torch.randn(shape[:-1] + (width,), generator=gen, device="cuda") * 2).to(dtype)
    return proj[..., :d]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(8, 4096), (256, 4096), (8, 2048), (256, 2048),
                                   (2, 3, 40), (1, 1, 8), (5, 1, 512), (300, 1024),
                                   (7, 8192), (3, 16384), (5, 520)], ids=str)
def test_rmsnorm_gated_matches_plain(dtype, shape):
    """The gate y * silu(z) fused, z read in place through its row stride;
    d 8192 at the one-pass path's 1024 threads, d 16384 and 520 (no whole
    number of warps) on the looped path."""
    gen = _gen(10)
    y = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.3).to(dtype)
    z = _gate(gen, shape, dtype)
    assert z.is_contiguous() == (z.numel() == shape[-1])  # one row is contiguous
    scale = torch.randn((shape[-1],), generator=gen, device="cuda") * 0.2 + 1
    got = rmsnorm(y, scale, 1e-5, gate=z)
    want = rmsnorm_ref(y, scale, 1e-5, gate=z)
    assert got.dtype == dtype and got.shape == y.shape
    torch.testing.assert_close(got.float(), want.float(), **RMS_TOL[dtype])
    assert K.LAUNCHES["rmsnorm"] == 1


def test_ssd_and_rmsnorm_wrappers_raise_rather_than_fall_back():
    args = list(_ssd_args(_gen(9), 1, 4, 16, 8, 1, 16, torch.float32))
    with pytest.raises(ValueError, match="contiguous"):
        ssd_intra_chunk(args[0].transpose(2, 3).contiguous().transpose(2, 3), *args[1:])
    with pytest.raises(TypeError):
        ssd_intra_chunk(args[0], args[1].bfloat16(), *args[2:])
    with pytest.raises(ValueError, match="chunk"):
        ssd_intra_chunk(*_ssd_args(_gen(9), 1, 4, 300, 8, 1, 16, torch.float32))
    with pytest.raises(ValueError, match="on"):
        ssd_intra_chunk(args[0], args[1].cpu(), *args[2:])
    x = torch.zeros(2, 64, device="cuda")
    with pytest.raises(TypeError):
        rmsnorm(x, torch.ones(64, device="cuda", dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="multiple"):
        rmsnorm(torch.zeros(2, 12, device="cuda", dtype=torch.bfloat16),
                torch.ones(12, device="cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm(torch.zeros(64, 2, device="cuda").T, torch.ones(64, device="cuda"))
    y, one = torch.zeros(4, 64, device="cuda"), torch.ones(64, device="cuda")
    with pytest.raises(ValueError, match="gate must be"):
        rmsnorm(y, one, gate=torch.zeros(4, 32, device="cuda"))
    with pytest.raises(TypeError, match="gate is"):
        rmsnorm(y, one, gate=y.bfloat16())
    with pytest.raises(ValueError, match="gate is on"):
        rmsnorm(y, one, gate=y.cpu())
    with pytest.raises(ValueError, match="16-byte"):
        rmsnorm(y, one, gate=torch.zeros(4, 66, device="cuda")[:, :64])  # row stride 264 bytes
    with pytest.raises(ValueError, match="16-byte"):
        rmsnorm(y, one, gate=torch.zeros(4, 68, device="cuda")[:, 1:65])  # base off by 4 bytes
    with pytest.raises(ValueError, match="16-byte"):
        rmsnorm(y, one, gate=torch.zeros(4, 128, device="cuda")[:, ::2])  # strided in d
    assert K.LAUNCHES["ssd"] == K.LAUNCHES["rmsnorm"] == 0


def test_ssm_prefill_and_decode_kernels_match_plain():
    """A narrow Mamba-2 model: a chunk of 64, a ragged tail of 21, then a
    decode step, with the kernels and with their plain versions; each
    prefill call launches the SSD kernel once per layer, every call the
    RMSNorm kernel twice per layer (pre-norm, gated norm)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    base = get_config("mamba2-1.3b")
    cfg = base.with_overrides(
        num_layers=2, d_model=256, vocab_size=1024, dtype=torch.float32,
        ssm=base.ssm.__class__(state_dim=64, head_dim=32, expand=2, conv_width=4,
                               chunk_size=64))
    params = init_params(T.model_layout(cfg), seed=0, device="cuda")
    rng = np.random.default_rng(2)
    toks = torch.as_tensor(rng.integers(1, 1024, size=(2, 86)), device="cuda")
    caches = [T.init_cache(cfg, 2, 128, device="cuda") for _ in range(2)]
    for lo, hi in ((0, 64), (64, 85)):
        got, _ = T.prefill_step(params, caches[0], cfg, tokens=toks[:, lo:hi], pos=lo)
        want, _ = T.prefill_step(params, caches[1], cfg, tokens=toks[:, lo:hi], pos=lo,
                                 kernels="plain")
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    lengths = torch.tensor([85, 85], dtype=torch.int32, device="cuda")
    got, _ = T.decode_step(params, caches[0], cfg, tokens=toks[:, 85], lengths=lengths)
    want, _ = T.decode_step(params, caches[1], cfg, tokens=toks[:, 85], lengths=lengths,
                            kernels="plain")
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    for key in ("conv", "state"):
        torch.testing.assert_close(caches[0]["block0"][key], caches[1]["block0"][key],
                                   atol=1e-4, rtol=1e-4)
    assert K.LAUNCHES == {"decode_attention": 0, "emit_norm_logits": 1, "attention": 0,
                          "ssd": 4, "rmsnorm": 12}


# ---------------------------------------------------------------------------
# The Stream core on the card: no host sync inside a chain, futures on a
# side stream, the paper's algorithms against their host oracles
# ---------------------------------------------------------------------------


class _NoHostSync:
    """``torch.cuda.set_sync_debug_mode("error")`` for the block."""

    def __enter__(self):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)
        return False


def test_sync_guard_catches_a_host_sync():
    x = torch.ones(4, device="cuda")
    with pytest.raises(RuntimeError):
        with _NoHostSync():
            x.sum().item()


@pytest.mark.parametrize("explicit_stream", [False, True])
def test_defer_on_a_side_stream_equals_direct(explicit_stream):
    from repro_torch.core import defer

    g = _gen(5)
    a = torch.randn(1024, 1024, device="cuda", generator=g)
    b = torch.randn(1024, 1024, device="cuda", generator=g)

    def f(u, v):
        return (torch.sin(u) * v + u.square()).cumsum(dim=1)

    side = torch.cuda.Stream() if explicit_stream else None
    with _NoHostSync():
        fut = defer(f, a, b, stream=side)
        busy = a
        for _ in range(6):
            busy = torch.tanh(busy @ b) * 0.5
        mapped = fut.map(lambda v: v * 2.0)
        value, doubled = fut.force(anchor=busy), mapped.force()
        after = value[:, -1] + busy[:, 0]
    torch.cuda.synchronize()
    assert fut._stream != torch.cuda.current_stream()
    if explicit_stream:
        assert fut._stream == side
    want = f(a, b)
    assert torch.equal(value, want) and torch.equal(doubled, want * 2.0)
    assert torch.isfinite(after).all()


def test_sieve_on_the_card_matches_eratosthenes():
    from repro_torch.algorithms import sieve
    from repro_torch.core import LazyEvaluator

    for limit, block, k in ((3000, 64, 4), (5000, 256, 16)):
        stream = sieve.sieve_stream(limit, block_size=block, primes_per_cell=k, device="cuda")
        with _NoHostSync():
            primes, count = sieve.sieve_result(stream.collect(LazyEvaluator()))
        ref = sieve.reference_primes(limit)
        p = primes.cpu().numpy()
        assert int(count) == len(ref)
        np.testing.assert_array_equal(p[p > 0], ref)


@pytest.mark.parametrize("limbs,factor", [(4, 1), (12, 100000000001)])
def test_fateman_power6_on_the_card(limbs, factor):
    """(1+x+y+z)^6 squared through times (4 x-chunks, 8 terms a cell) and
    times_dense, against the exact product and the CPU's bits."""
    from repro_torch.algorithms import polynomial as poly

    x = poly.fateman_poly(6, 96, limbs, factor, device="cuda")
    with _NoHostSync():
        got = poly.times(x, x, num_x_chunks=4, terms_per_cell=8)
        dense = poly.times_dense(x, x)
    ref = poly.reference_product(poly.to_dict(x), poly.to_dict(x))
    assert poly.to_dict(got) == ref and poly.to_dict(dense) == ref
    xc = poly.fateman_poly(6, 96, limbs, factor, device="cpu")
    cpu = poly.times(xc, xc, num_x_chunks=4, terms_per_cell=8)
    assert torch.equal(got.keys.cpu(), cpu.keys) and torch.equal(got.coeffs.cpu(), cpu.coeffs)


def test_sample_token_on_card_logits_equals_cpu_draw():
    """Logits from the emit kernel, read back to the host, draw what the
    same values drawn one row at a time on the CPU draw."""
    from repro_torch.serve.engine import sample_token

    g = _gen(6)
    x = torch.randn(8, 1, 256, device="cuda", generator=g).to(torch.bfloat16)
    w = (torch.randn(1000, 256, device="cuda", generator=g) * 0.2).to(torch.bfloat16)
    logits = emit_norm_logits(x, w, norm="rmsnorm", scale=torch.ones(256, device="cuda"),
                              tied=True).cpu().numpy()
    assert logits.dtype == np.float32
    uids, ngens = np.arange(8, dtype=np.int32) * 3, np.arange(8, dtype=np.int32) % 3
    drawn = sample_token(logits, 0.9, 11, uids, ngens)
    rows = np.array(logits.tolist(), np.float32)
    assert drawn.tolist() == [int(sample_token(rows[i], 0.9, 11, int(u), int(n)))
                              for i, (u, n) in enumerate(zip(uids, ngens))]
    assert K.LAUNCHES["emit_norm_logits"] == 1


@pytest.mark.parametrize("temperature", [0.0, 0.9], ids=["greedy", "t0.9"])
def test_engine_draws_on_the_card_and_copies_back_only_the_ids(temperature, tmp_path):
    """The narrow OLMo (kernels="cuda") served by the ``Engine`` at B 64:
    every token it appends is the host draw of the logits behind it (a
    decode step's active rows, an admission's last prefill row; greedy
    with a maximum planted twice in two rows), and under torch.profiler
    a decoding step copies at most 4 B bytes, the int32 ids, from the
    card to the host."""
    import json

    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.serve.engine import Engine, ServeConfig, sample_token

    cfg, params = _serving_model("olmo-1b")
    b = 64
    scfg = ServeConfig(max_batch=b, max_len=128, prefill_chunk=16, max_new_tokens=12,
                       temperature=temperature, seed=11)
    rng = np.random.default_rng(8)

    eng = Engine(params, cfg, scfg, device="cuda")
    prefill, decode, single = eng._prefill, eng._decode, eng._prefill_single
    last, drawn = {}, []

    def planted(logits):
        if temperature > 0:
            return logits
        logits = logits.clone()
        rows = logits.view(-1, logits.shape[-1])
        for r, at in ((0, 0), (rows.shape[0] - 1, rows.shape[1] - 1)):
            rows[r, at] = rows[r].max()
        return logits

    def kept_prefill(*args, **kw):
        logits, cache = prefill(*args, **kw)
        last["prefill"] = planted(logits)
        return last["prefill"], cache

    def kept_decode(*args, **kw):
        logits, cache = decode(*args, **kw)
        logits = planted(logits)
        slots = [i for i, r in enumerate(eng.active) if r is not None]
        reqs = [eng.active[i] for i in slots]
        ngens = np.array([len(r.out_tokens) for r in reqs], np.int32)
        host = sample_token(logits.cpu().numpy()[slots], temperature, 11,
                            np.array([r.uid for r in reqs], np.int32), ngens)
        drawn.extend(zip(reqs, ngens.tolist(), host.tolist()))
        return logits, cache

    def checked_single(req):
        out = single(req)
        host = sample_token(last["prefill"].cpu().numpy()[0], temperature, 11, req.uid, 0)
        drawn.append((req, 0, int(host)))
        return out

    eng._prefill, eng._decode, eng._prefill_single = kept_prefill, kept_decode, checked_single
    reqs = [eng.submit(rng.integers(1, cfg.vocab_size, size=int(n)), int(k))
            for n, k in zip(rng.integers(1, 40, size=96), rng.integers(1, 13, size=96))]
    eng.run_until_drained()
    assert all(r.done and r.status == "ok" for r in reqs)
    assert len(drawn) == sum(len(r.out_tokens) for r in reqs) and eng.decode_steps > 0
    assert all(req.out_tokens[k] == tok for req, k, tok in drawn)

    # a steady decoding step under the profiler: every slot active, no admission
    eng = Engine(params, cfg, scfg, device="cuda")
    for _ in range(b):
        eng.submit(rng.integers(1, cfg.vocab_size, size=20), 12)
    eng.step()
    eng.step()
    torch.cuda.synchronize()
    steps = eng.decode_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        torch.cuda._sleep(1_000_000)  # the warm-up phase, whose events are dropped
        torch.cuda.synchronize()
        prof.step()
        eng.step()
        torch.cuda.synchronize()
    assert eng.decode_steps == steps + 1 and None not in eng.active
    path = tmp_path / "step.json"
    prof.export_chrome_trace(str(path))
    copies = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")]
    moved = sum(int(e["args"]["bytes"]) for e in copies)
    assert copies and 0 < moved <= 4 * b, [(e["name"], e["args"].get("bytes")) for e in copies]


# ---------------------------------------------------------------------------
# The FutureEvaluator on stage streams, and the StreamEngine's rounds
# ---------------------------------------------------------------------------

SLEEP_CYCLES = 200_000  # about 0.1 ms at the H100's clock


def _slowed(stream, cycles):
    """``stream`` (whose sink is a segment) with every cell prefixed by a
    ``torch.cuda._sleep`` on the stream it is issued on, so that a
    consumer that does not wait for its producer reads a wrong value."""
    import dataclasses

    from repro_torch.core import Stream

    seg = stream.node
    inner = seg.cell_fn

    def cell(*args):
        torch.cuda._sleep(cycles)
        return inner(*args)

    return Stream(dataclasses.replace(seg, cell_fn=cell))


def _future_programs():
    from repro_torch.algorithms import polynomial as poly
    from repro_torch.algorithms import sieve
    from repro_torch.core import Stream

    w8 = torch.arange(8, dtype=torch.float32, device="cuda")

    def cell(state, item):
        return state + 1, item * 1.001 + state

    def equiv(m):
        items = torch.linspace(0, 1, 3 * m, device="cuda").reshape(m, 3)
        return Stream.source(items).through(cell, w8)

    x = poly.fateman_poly(6, 128, 4, device="cuda")  # 16 cells of 8 terms
    return {
        "equiv": lambda: equiv(6),
        "equiv_ragged": lambda: equiv(5),
        "sieve": lambda: sieve.sieve_stream(600, block_size=64, primes_per_cell=2,
                                            num_cells=56, device="cuda"),
        "fateman6": lambda: poly.times_stream(x, x, num_x_chunks=4, terms_per_cell=8),
    }


@pytest.mark.parametrize("slow", [False, True], ids=["plain", "slowed"])
@pytest.mark.parametrize("name", ["equiv", "equiv_ragged", "sieve", "fateman6"])
def test_future_on_four_streams_equals_lazy(name, slow):
    from repro_torch import pytree as P
    from repro_torch.core import FutureEvaluator, LazyEvaluator

    make = _future_programs()[name]
    want = make().collect(LazyEvaluator())
    for schedule, v in (("gpipe", 1), ("one_f_one_b", 1), ("interleaved", 2)):
        stream = make()
        if slow:
            stream = _slowed(stream, SLEEP_CYCLES)
        ev = FutureEvaluator(4, schedule=schedule, interleave=v)
        with _NoHostSync():
            got = stream.collect(ev)
        torch.cuda.synchronize()
        for a, b in zip(P.leaves((got.items, got.states)), P.leaves((want.items, want.states))):
            assert torch.equal(a, b), (name, schedule)


def test_future_stages_overlap_on_the_card():
    """Each stage runs on a stream of its own: with every cell slowed,
    the units of two stages overlap in time (events per stage and tick)."""
    from repro_torch.core import FutureEvaluator

    stream = _slowed(_future_programs()["equiv"](), 2_000_000)
    ev = FutureEvaluator(4, time_units=True)
    stream.collect(ev)
    torch.cuda.synchronize()
    units = ev.unit_times()
    assert len(units) == 4 * 6 and len({d for d, *_ in units}) == 4
    overlap = [(a, b) for a in units for b in units
               if a[0] < b[0] and a[2] < b[3] and b[2] < a[3]]
    assert overlap


def _serving_model(arch):
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    base = get_config(arch)
    if arch == "olmo-1b":
        cfg = base.with_overrides(num_layers=4, d_model=256, num_heads=4, num_kv_heads=4,
                                  head_dim=64, d_ff=512, vocab_size=1024)
    else:
        cfg = base.with_overrides(
            num_layers=4, d_model=256, vocab_size=1024,
            ssm=base.ssm.__class__(state_dim=64, head_dim=32, expand=2, conv_width=4,
                                   chunk_size=64))
    return cfg, init_params(T.model_layout(cfg), seed=0, device="cuda")


@pytest.mark.parametrize("temperature", [0.0, 0.9], ids=["greedy", "t0.9"])
@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-1.3b"])
def test_stream_engine_future_equals_lazy_on_the_card(arch, temperature):
    """Narrow OLMo and Mamba2 (4 layer groups, kernels="cuda") through
    the StreamEngine: Lazy, and Future on 2 stage streams under gpipe and
    interleaved, emit identical tokens, every round without a host sync
    inside its collect, and the kernels launched once per (item, layer)
    and once per emitted item."""
    from repro_torch.configs.base import DecodePipelineConfig
    from repro_torch.serve.engine import ServeConfig, StreamEngine

    cfg, params = _serving_model(arch)
    ck = 64 if arch == "mamba2-1.3b" else 16
    scfg = ServeConfig(max_batch=4, max_len=256, prefill_chunk=ck, max_new_tokens=7,
                       temperature=temperature, seed=11)
    rng = np.random.default_rng(4)
    lens = [64, 128, 64, 192, 128, 64] if arch == "mamba2-1.3b" else [5, 40, 17, 64, 3, 30]
    prompts = [rng.integers(1, 1024, size=n) for n in lens]
    budgets = [7, 3, 5, 6, 2, 7]
    outs = []
    for stages, schedule, v in ((None, "gpipe", 1), (2, "gpipe", 1), (2, "interleaved", 2)):
        pcfg = DecodePipelineConfig(num_cells=4, microbatches=2, round_steps=3,
                                    admit_per_round=2, schedule=schedule, interleave=v,
                                    kernels="cuda")
        eng = StreamEngine(params, cfg, scfg, pcfg, stages=stages, device="cuda")
        round_fn = eng._round

        def guarded(*args, _f=round_fn):
            with _NoHostSync():
                return _f(*args)

        eng._round = guarded
        reqs = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
        K.reset_launches()
        eng.run_until_drained()
        items = eng.rounds * 3 * 2
        assert K.LAUNCHES["emit_norm_logits"] == items
        assert K.LAUNCHES["decode_attention"] == (items * 4 if arch == "olmo-1b" else 0)
        assert all(r.done and len(r.out_tokens) == b for r, b in zip(reqs, budgets))
        outs.append([r.out_tokens for r in reqs])
    assert outs[1] == outs[0] and outs[2] == outs[0]


def test_tensor_threefry_on_the_card_equals_numpy():
    from repro_torch.serve import prng
    from repro_torch.serve.engine import sample_token, sample_token_t

    uids = np.array([0, 1, 2, 3, 7, 11, 12, 2**31 - 1], np.int32)
    ngens = np.array([0, 5, 1, 1, 2, 0, 3, 9], np.int32)
    kn = prng.request_key(11, uids, ngens)
    uid_t, ngen_t = torch.as_tensor(uids).cuda(), torch.as_tensor(ngens).cuda()
    lg = (np.random.default_rng(2).normal(size=(8, 50304)) * 3).astype(np.float32)
    lg_t = torch.as_tensor(lg).cuda()
    with _NoHostSync():
        kt = prng.request_key_t(11, uid_t, ngen_t)
        bits = prng.random_bits_t(kt, (50304,))
        uni = prng.uniform_t(kt, (50304,), minval=np.finfo(np.float32).tiny)
        noise = prng.gumbel_t(kt, (50304,))
    np.testing.assert_array_equal(kt.cpu().numpy(), kn.astype(np.int64))
    np.testing.assert_array_equal(bits.cpu().numpy(), prng.random_bits(kn, (50304,)).astype(np.int64))
    np.testing.assert_array_equal(uni.cpu().numpy().view(np.uint32),
                                  prng.uniform(kn, (50304,), minval=np.finfo(np.float32).tiny).view(np.uint32))
    want = prng.gumbel(kn, (50304,))
    ulp = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
    assert (np.abs(noise.cpu().numpy().astype(np.float64) - want) <= 2 * ulp).all()
    with _NoHostSync():
        got = sample_token_t(lg_t, 0.9, 11, uid_t, ngen_t)
    np.testing.assert_array_equal(got.cpu().numpy(), sample_token(lg, 0.9, 11, uids, ngens))


# ---------------------------------------------------------------------------
# Faults in the middle of a Future round, and the supervisor on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule,v", [("gpipe", 1), ("interleaved", 2)])
def test_future_raise_mid_plan_joins_the_stage_streams(schedule, v):
    """Cells that write their state in place, each slowed on its stage
    stream, and one that raises at item 3 while earlier items are still
    queued on the other stages: a restore issued on the caller's stream
    right after the exception, with no host sync, is not overtaken by
    those writes (the evaluator joins every stage stream to the caller on
    the exception path too)."""
    from repro_torch.core import FutureEvaluator, Stream
    from repro_torch.core import graph as G

    state = torch.arange(8 * 16, dtype=torch.float32, device="cuda").reshape(8, 16)
    items = torch.linspace(0, 1, 6 * 16, device="cuda").reshape(6, 16)
    snap = state.clone()

    def cell(s, item):
        torch.cuda._sleep(20 * SLEEP_CYCLES)
        if G.current_item() == 3:
            raise RuntimeError("a cell fails mid-plan")
        s.mul_(1.5).add_(item)
        return s, item + 1

    ev = FutureEvaluator(4, schedule=schedule, interleave=v)
    with pytest.raises(RuntimeError, match="mid-plan"):
        with _NoHostSync():
            Stream.source(items).through(cell, state).collect(ev)
    state.copy_(snap)  # the restore, on the caller's stream, the host not waiting
    torch.cuda.synchronize()
    assert torch.equal(state, snap)


def _supervised_stream_engine(stages=2):
    from repro_torch.configs.base import DecodePipelineConfig
    from repro_torch.serve.engine import ServeConfig, StreamEngine

    cfg, params = _serving_model("olmo-1b")
    scfg = ServeConfig(max_batch=4, max_len=256, prefill_chunk=16, max_new_tokens=7)
    pcfg = DecodePipelineConfig(num_cells=4, microbatches=2, round_steps=3, admit_per_round=2,
                                kernels="cuda")
    eng = StreamEngine(params, cfg, scfg, pcfg, stages=stages, device="cuda")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 1024, size=n) for n in (5, 40, 17, 64, 3, 30)]
    return eng, prompts


def test_supervisor_replays_a_mid_round_fault_on_the_card():
    """StreamEngine under Future on 2 stage streams, every cell slowed:
    a cell raising at item 3 of round 1 is restored and replayed to the
    fault-free tokens; the cache tensors keep their storage; a snapshot
    after a slowed round equals the cache once the card is idle; the
    snapshot is in pinned host memory."""
    from repro_torch import pytree as P
    from repro_torch.core import graph as G
    from repro_torch.serve.supervisor import ServeSupervisor

    eng, prompts = _supervised_stream_engine()
    sup = ServeSupervisor(eng)
    pristine = sup.snapshot()
    assert all(h.is_pinned() for h in P.leaves(pristine.device))
    reqs = [sup.submit(p) for p in prompts]
    sup.run_until_drained()
    want = [r.out_tokens for r in reqs]
    ptrs = [t.data_ptr() for t in P.leaves(eng.cell_states)]

    inner, state = eng._cell_fn, {"round": -1, "armed": True}
    collect = eng._round

    def counted_round(*args):
        state["round"] += 1
        return collect(*args)

    def cell(const, s, item):
        torch.cuda._sleep(SLEEP_CYCLES)
        if state["armed"] and state["round"] == 1 and G.current_item() == 3:
            state["armed"] = False
            raise RuntimeError("a cell fails mid-round")
        return inner(const, s, item)

    eng._cell_fn, eng._round = cell, counted_round
    sup = ServeSupervisor(eng)
    sup.restore(pristine)
    reqs = [sup.submit(p) for p in prompts]
    sup.step()
    snap = sup.snapshot()
    torch.cuda.synchronize()
    for leaf, host in zip(P.leaves(eng.cell_states), P.leaves(snap.device)):
        assert torch.equal(leaf.cpu(), host)
    sup.run_until_drained()
    assert not state["armed"] and sup.stats["restarts"] == 1
    assert sup.stats["requests_lost"] == 0
    assert [r.out_tokens for r in reqs] == want
    assert [t.data_ptr() for t in P.leaves(eng.cell_states)] == ptrs


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), float("-inf")])
def test_numerics_scan_finds_one_nonfinite_element_on_the_card(bad):
    """One non-finite element anywhere in a bf16 cache leaf on the card is
    found (the scan reduces each leaf's minimum and maximum there), and a
    restore clears it."""
    from repro_torch.serve.supervisor import NumericsFault, ServeSupervisor

    eng, _ = _supervised_stream_engine(stages=None)
    sup = ServeSupervisor(eng)
    pristine = sup.snapshot()
    sup._check_numerics()
    leaf = eng.cell_states["cache"]["block0"]["v"]
    assert leaf.dtype == torch.bfloat16
    leaf[3, 0, 2, 200, 1, 63] = bad
    with pytest.raises(NumericsFault):
        sup._check_numerics()
    sup.restore(pristine)
    sup._check_numerics()


# ---------------------------------------------------------------------------
# Mixture-of-Experts on the card: routes, repeatability, no host sync
# ---------------------------------------------------------------------------


def _moe_case(d, e, k, f, shared, dtype, tokens, seed=0):
    from repro_torch.configs.base import MoEConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe as M
    from repro_torch.models.params import init_params

    moe = MoEConfig(num_experts=e, top_k=k, d_ff_expert=f, num_shared_experts=shared)
    cfg = get_config("moonshot-v1-16b-a3b").with_overrides(d_model=d, moe=moe, dtype=dtype)
    params = init_params(M.moe_layout(cfg, moe), seed=seed, device="cuda")
    x = torch.randn((1, tokens, d), generator=_gen(seed + 1), device="cuda").to(dtype)
    return moe, params, x


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("tokens", [8, 131])
def test_moe_apply_on_the_card_matches_the_cpu(dtype, tokens):
    """The same function on CPU copies of the inputs: routes, ranks and
    keep equal; y within 1e-5 (fp32) or 4 bf16 ulps of each row's
    largest |y| (bf16: a rounding moved by an fp32 sum in another
    order, as against the JAX package in tests/test_torch_moe.py)."""
    from repro_torch.models import moe as M

    moe, params, x = _moe_case(512, 16, 4, 256, 2, dtype, tokens)
    cpu = {k: (v.cpu() if torch.is_tensor(v) else {a: b.cpu() for a, b in v.items()})
           for k, v in params.items()}
    with M.record_routes() as routes:
        got, aux = M.moe_apply(params, x, moe)
        want, aux_cpu = M.moe_apply(cpu, x.cpu(), moe)
    for key in ("expert_ids", "rank", "keep"):
        assert torch.equal(routes[0][key].cpu(), routes[1][key]), key
    got, want = got.cpu().float(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    else:
        top = want.abs().amax(dim=-1, keepdim=True)
        ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
        assert bool(((got - want).abs() <= 4 * ulp).all())
    for key in aux:
        torch.testing.assert_close(aux[key].cpu(), aux_cpu[key], atol=1e-6, rtol=0)


@pytest.mark.parametrize("tokens", [8, 128])
def test_moe_apply_is_repeatable_and_never_syncs(tokens):
    """Moonlight's widths (64 experts, top-6, 2 shared): 20 calls give the
    same bits (the combine adds in a fixed order), under the sync guard."""
    from repro_torch.models import moe as M

    moe, params, x = _moe_case(2048, 64, 6, 1408, 2, torch.bfloat16, tokens)
    first, _ = M.moe_apply(params, x, moe)
    with _NoHostSync():
        outs = [M.moe_apply(params, x, moe)[0] for _ in range(20)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, first) for o in outs)


def test_moonlight_layer_decode_routes_equal_the_plain_path():
    """One full-width Moonlight layer (vocab cut to 4096), fp32: a decode
    step with the kernels and with kernels="plain" on copies of a
    prefilled cache routes every row alike and gives the same logits."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    cfg = get_config("moonshot-v1-16b-a3b").with_overrides(num_layers=1, vocab_size=4096,
                                                            dtype=torch.float32)
    params = init_params(T.model_layout(cfg), seed=0, device="cuda")
    rng = np.random.default_rng(5)
    toks = torch.as_tensor(rng.integers(1, 4096, size=(8, 33)), device="cuda")
    base = T.init_cache(cfg, 8, 64, device="cuda")
    T.prefill_step(params, base, cfg, tokens=toks[:, :32], pos=0, kernels="plain")
    lengths = torch.full((8,), 32, dtype=torch.int32, device="cuda")
    runs = []
    for mode in ("cuda", "plain"):
        cache = {n: {k: t.clone() for k, t in blk.items()} for n, blk in base.items()}
        K.reset_launches()
        with M.record_routes() as routes:
            logits, _ = T.decode_step(params, cache, cfg, tokens=toks[:, 32], lengths=lengths,
                                      kernels=mode)
        runs.append((logits, routes, dict(K.LAUNCHES)))
    (got, r_cuda, launched), (want, r_plain, _) = runs
    assert launched == {"decode_attention": 1, "emit_norm_logits": 1, "attention": 0,
                        "ssd": 0, "rmsnorm": 2}
    for key in ("expert_ids", "keep"):
        assert torch.equal(r_cuda[0][key], r_plain[0][key])
    top = want.abs().amax(dim=-1, keepdim=True)
    assert bool(((got - want).abs() <= 1e-4 * top).all())


# ---------------------------------------------------------------------------
# The zoo's last two input kinds: llama-3.2-vision's cross-attention
# shapes and musicgen-medium's widths, then both smoke models on the card
# against the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("sq", [1, 128])
def test_flash_attention_cross_shapes_match_plain(dtype, sq):
    """llama-3.2-vision's cross-attention: B 8, 64 heads over 8 KV heads
    of 128, every query against all 1601 vision keys (not a multiple of
    the 64-key tile), non-causal; Sq 1 is a decode step's, 128 a prefill
    chunk's."""
    q, k, v = _flash_args(_gen(20), 8, sq, 1601, 64, 8, 128, dtype)
    got = flash_attention(q, k, v, causal=False)
    want = flash_attention_ref(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(), atol=FLASH_TOL[dtype], rtol=FLASH_TOL[dtype])
    assert K.LAUNCHES["attention"] == 1


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_decode_attention_musicgen_mha_matches_plain(dtype):
    """musicgen-medium's 24 heads of 64, one KV head each, over a
    1024-row cache; row 0 a fresh admission."""
    s = 1024
    args, pos, kv_len = _decode_args(_gen(21), 8, s, 24, 24, 64, dtype,
                                     [0, s - 1, 517, 128, 64, 900, 1000, 3])
    got = fused_decode_attention(*args, pos=pos, kv_len=kv_len)
    want = decode_attention_ref(*args, pos=pos, kv_len=kv_len)
    tol = DECODE_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert K.LAUNCHES["decode_attention"] == 1


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(8, 1536), (128, 1536), (8, 8192), (128, 8192)], ids=str)
def test_rmsnorm_zoo_widths_match_plain(dtype, shape):
    """The block pre-norms of musicgen-medium (d 1536) and
    llama-3.2-vision (d 8192) at a decode step's 8 rows and a 128-token
    chunk's."""
    gen = _gen(22)
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.3).to(dtype)
    scale = torch.randn((shape[-1],), generator=gen, device="cuda") * 0.2 + 1
    got = rmsnorm(x, scale, 1e-5)
    torch.testing.assert_close(got.float(), rmsnorm_ref(x, scale, 1e-5).float(), **RMS_TOL[dtype])
    assert K.LAUNCHES["rmsnorm"] == 1


def _zoo_smoke(arch):
    """The arch's smoke config at widths the kernels take (heads of 64;
    llama-3.2-vision with 100 vision tokens and its gates set nonzero),
    fp32, on the CPU and on the card: the same weights."""
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params, map_tree

    over = dict(d_model=256, head_dim=64, dtype=torch.float32)
    if arch == "llama-3.2-vision-90b":
        over["vision_tokens"] = 100
    cfg = smoke_config(get_config(arch)).with_overrides(**over)
    cpu = init_params(T.model_layout(cfg), seed=0, device="cpu")
    for blk in cpu["blocks"].values():
        if "xattn_gate" in blk:
            blk["xattn_gate"]["gate"].fill_(0.8)
    return cfg, cpu, map_tree(lambda t: t.to("cuda"), cpu)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "musicgen-medium"])
def test_zoo_prefill_and_decode_on_the_card_match_the_cpu(arch):
    """A 40-row chunk at 0 (llama-3.2-vision: with fresh vision embeds),
    a 24-row chunk at 40 (reading the cached vision K/V) and two decode
    steps, each fed a window of one longer sequence (musicgen's frames
    a strided view): the card with the kernels (flash for every prefill attention
    and for the decode steps' cross-attention) against the CPU's plain
    ops, logits and every cache leaf within 1e-4; exact launches."""
    from repro_torch.models import transformer as T

    cfg, cpu, card = _zoo_smoke(arch)
    vision = arch == "llama-3.2-vision-90b"
    gen = torch.Generator().manual_seed(23)
    b = 3
    feed = (torch.randn((b, 66, cfg.d_model), generator=gen) if cfg.embeds_input
            else torch.randint(1, cfg.vocab_size, (b, 66), generator=gen))
    ve = torch.randn((b, cfg.vision_tokens, cfg.d_model), generator=gen) if vision else None
    caches = {"cpu": T.init_cache(cfg, b, 96, device="cpu"),
              "cuda": T.init_cache(cfg, b, 96, device="cuda")}
    plans = T.block_plans(cfg)
    groups = cfg.num_layers // len(plans)
    own = groups * sum(p.mixer == "attn" for p in plans)
    cross = groups * sum(p.mixer == "cross_attn" for p in plans)

    feeds = {"cpu": feed, "cuda": feed.to("cuda")}

    def call(dev, lo, hi, fresh):
        p, kernels = (card, "cuda") if dev == "cuda" else (cpu, "plain")
        x = feeds[dev][:, lo:hi]  # a strided window of the sequence
        key = "embeds" if cfg.embeds_input else "tokens"
        if hi - lo > 1:
            return T.prefill_step(p, caches[dev], cfg, **{key: x}, pos=lo, kernels=kernels,
                                  attn_impl="flash" if dev == "cuda" else "dense",
                                  vision_embeds=ve.to(dev) if fresh else None)[0]
        if not cfg.embeds_input:
            x = x[:, 0]
        lengths = torch.full((b,), lo, dtype=torch.int32, device=dev)
        return T.decode_step(p, caches[dev], cfg, **{key: x}, lengths=lengths, kernels=kernels,
                             attn_impl="flash" if dev == "cuda" else "dense")[0]

    norms = 2 * cfg.num_layers
    for lo, hi, fresh in ((0, 40, vision), (40, 64, False), (64, 65, False), (65, 66, False)):
        K.reset_launches()
        got = call("cuda", lo, hi, fresh)
        want = call("cpu", lo, hi, fresh)
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
        expected = ({"decode_attention": 0, "emit_norm_logits": 0, "attention": own + cross,
                     "ssd": 0, "rmsnorm": norms} if hi - lo > 1 else
                    {"decode_attention": own, "emit_norm_logits": 1, "attention": cross,
                     "ssd": 0, "rmsnorm": norms})
        assert K.LAUNCHES == expected, (lo, K.LAUNCHES)
    for name, blk in caches["cpu"].items():
        for key, t in blk.items():
            torch.testing.assert_close(caches["cuda"][name][key].cpu(), t, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# Training: the plain ops on the card, the planned backward on stage streams
# ---------------------------------------------------------------------------


def test_train_step_on_the_card_matches_the_cpu():
    """Two fp32 AdamW steps (2 microbatches, remat) of a smoke config on
    the card against the same steps on the CPU: losses, grad norms and
    every leaf of the params and moments within 1e-4 relative (to the
    leaf's largest value); no kernel launches."""
    from repro_torch import pytree as P
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.train import AdamWConfig, TrainConfig, init_opt_state, make_train_step

    cfg = smoke_config(get_config("olmo-1b")).with_overrides(dtype=torch.float32)
    params = init_params(T.model_layout(cfg), seed=0, device="cpu")
    ocfg = AdamWConfig(learning_rate=1e-3, eps=1e-3, warmup_steps=1, total_steps=4)
    step_fn = make_train_step(cfg, TrainConfig(num_microbatches=2, kernels="auto"), ocfg)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(2):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 33)).astype(np.int32))
        batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    out = {}
    for device in ("cpu", "cuda"):
        p = P.tree_map(lambda t: t.to(device), params)
        o = init_opt_state(p, ocfg)
        metrics = []
        for b in batches:
            p, o, m = step_fn(p, o, {k: v.to(device) for k, v in b.items()})
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
        out[device] = (p, o, metrics)
    assert K.LAUNCHES == {op: 0 for op in K.OPS}
    np.testing.assert_allclose(out["cuda"][2], out["cpu"][2], rtol=1e-4)
    for got, want in zip(P.leaves(out["cuda"][:2]), P.leaves(out["cpu"][:2])):
        got, want = got.cpu().float(), want.float()
        assert (got - want).abs().max() <= 1e-4 * max(want.abs().max().item(), 1e-30)


@pytest.mark.parametrize("schedule,v", [("gpipe", 1), ("one_f_one_b", 1), ("interleaved", 2)])
def test_planned_backward_equals_autodiff_on_stage_streams(schedule, v):
    """A chain of 8 cells with slowed cells (``torch.cuda._sleep``) on 4
    stage streams of the card: outputs and gradients of Lazy,
    Future/autodiff and Future/planned bitwise equal."""
    from repro_torch.core import FutureEvaluator, LazyEvaluator, Stream

    g = _gen(5)
    w = torch.randn(8, 64, 64, generator=g, device="cuda") * 0.2
    items = torch.randn(6, 32, 64, generator=g, device="cuda")

    def cell(ww, x):
        torch.cuda._sleep(20000)
        return ww, torch.tanh(x @ ww) + x

    def run(ev):
        wl = w.clone().requires_grad_(True)
        xi = items.clone().requires_grad_(True)
        out = Stream.source(xi).through(cell, wl, mutable_state=False, remat=True).collect(ev)
        grads = torch.autograd.grad(out.items.square().mean(), [wl, xi])
        torch.cuda.synchronize()
        return [out.items.detach()] + list(grads)

    want = run(LazyEvaluator())
    for backward in ("autodiff", "planned"):
        got = run(FutureEvaluator(4, schedule=schedule, interleave=v, backward=backward))
        assert all(torch.equal(a, b) for a, b in zip(got, want)), backward


def test_kernel_guard_stops_a_cuda_tensor_that_requires_grad():
    """``get_impl(op, "cuda")`` under autograd with a CUDA input that
    requires grad raises before launching; under ``no_grad`` it runs."""
    q = torch.randn(1, 8, 2, 64, device="cuda", requires_grad=True)
    k = torch.randn(1, 8, 2, 64, device="cuda")
    attention = K.get_impl("attention", "cuda")
    with pytest.raises(RuntimeError, match="'attention' CUDA kernel.*no backward"):
        attention(q, k, k, causal=True)
    assert K.LAUNCHES["attention"] == 0
    with torch.no_grad():
        attention(q, k, k, causal=True)
    assert K.LAUNCHES["attention"] == 1
    x = torch.randn(4, 256, device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="'rmsnorm' CUDA kernel"):
        K.get_impl("rmsnorm", "cuda")(x, torch.ones(256, device="cuda"), 1e-5)


def _profiled_decode_steps(steps):
    """A narrow qwen3 (2 layers, GQA 8/2 x 128, untied) decode step
    ``steps`` times under torch.profiler (``trace.profile_steps``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.roofline import trace as TR

    cfg = get_config("qwen3-32b").with_overrides(
        num_layers=2, d_model=512, num_heads=8, num_kv_heads=2, d_ff=1024, vocab_size=1024)
    params = init_params(T.model_layout(cfg), seed=0, device="cuda")
    cache = T.init_cache(cfg, 4, 96, device="cuda")
    rng = np.random.default_rng(0)
    T.prefill_step(params, cache, cfg, pos=0,
                   tokens=torch.as_tensor(rng.integers(1, 1024, size=(4, 64)), device="cuda"))
    tokens = torch.as_tensor(rng.integers(1, 1024, size=4), device="cuda")
    lengths = torch.tensor([64, 10, 0, 63], dtype=torch.int32, device="cuda")
    T.decode_step(params, cache, cfg, tokens=tokens, lengths=lengths)  # first launches
    K.reset_launches()
    records = TR.profile_steps(
        lambda _: T.decode_step(params, cache, cfg, tokens=tokens, lengths=lengths), steps)
    slab = 4 * 96 * cfg.num_kv_heads * cfg.head_dim * 2
    return records, slab


def test_trace_counts_a_decode_steps_launches():
    """roofline/trace.py on a real trace: exact launches a step, equal to
    the launch counters; the emit and attention on the one stream; no
    slab copy; an idle share strictly between 0 and 1."""
    from repro_torch.roofline import trace as TR

    records, slab = _profiled_decode_steps(3)
    assert TR.lost_launches(records) == 0
    assert TR.launches(records, "decode_attention_kernel") == [2, 2, 2]
    assert TR.launches(records, "emit_untied_tma_kernel") == [1, 1, 1]
    assert TR.launches(records, "rmsnorm_*") == [4, 4, 4]
    assert TR.launches(records, "flash_*") == [0, 0, 0]
    assert K.LAUNCHES == {"decode_attention": 6, "emit_norm_logits": 3, "attention": 0,
                          "ssd": 0, "rmsnorm": 12}
    stream = TR.launch_streams(records, "decode_attention_kernel")
    assert len(stream) == 1 and TR.only_on_streams(records, "emit_*", stream)
    assert TR.slab_copies(records, slab) == 0
    window = TR.span_window(records)
    assert 0 < TR.idle_share(records, window) < 1
    assert TR.device_busy_us(records, window) > 0
    assert TR.kernel_time_by_name(records, 50, window)


def test_trace_raises_without_cuda_activity():
    """No CUDA activity in the trace is no reading: a profile of card work
    with the CPU activity only, and one of host work with both."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.roofline import trace as TR

    x = torch.randn(256, 256, device="cuda")
    for activities, fn in (([ProfilerActivity.CPU], lambda: x @ x),
                           ([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                            lambda: torch.randn(64, 64) @ torch.randn(64, 64))):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            with record_function(TR.STEP_SPAN):
                fn()
                torch.cuda.synchronize()
        records = TR.records_from_profile(prof)
        assert records
        with pytest.raises(TR.NoDeviceActivity):
            TR.idle_share(records, TR.span_window(records))
        with pytest.raises(TR.NoDeviceActivity):
            TR.launches(records, "*")


def test_torch_quickstart_runs_on_the_card(capsys):
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / "torch_quickstart.py"
    spec = importlib.util.spec_from_file_location("torch_quickstart", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main([])
    printed = capsys.readouterr().out
    assert "lazy == future: True" in printed and "zip: lazy == future: True" in printed
    np.testing.assert_array_equal(out["lazy"], out["future"])
    assert len(out["primes"]) == 46 and out["chunks"] > 0
    assert all(len(t) == 6 for t in out["served"].values())


def test_torch_serve_lm_runs_on_the_card(capsys):
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / "torch_serve_lm.py"
    spec = importlib.util.spec_from_file_location("torch_serve_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    done = mod.main([])
    assert len(done) == 12 and all(len(r.out_tokens) == 8 for r in done)
    assert "device=cuda" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The mesh layer on a one-rank NCCL process group (NCCL refuses two ranks
# on one GPU; tests/test_torch_mesh.py runs four gloo ranks on the CPU)
# ---------------------------------------------------------------------------


@pytest.fixture
def nccl_mesh():
    """A (data 1, model 1) mesh over a one-rank NCCL group on cuda:0."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        assert dist.get_backend() == "nccl" and mesh.device_type == "cuda"
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_one_rank_nccl_collectives_are_their_size_one_results(nccl_mesh, dtype):
    from repro_torch.core.future import all_gather_future, psum_scatter_future
    from repro_torch.parallel import collectives as C
    from repro_torch.train.compression import compress_decompress

    x = torch.randn((6, 130), generator=_gen(3), device="cuda").to(dtype)
    for axis in ("data", "model"):
        assert torch.equal(all_gather_future(x, axis, mesh=nccl_mesh).force(), x)
        assert torch.equal(all_gather_future({"a": x}, axis, tiled=False,
                                             mesh=nccl_mesh).force()["a"], x[None])
        assert torch.equal(psum_scatter_future(x, axis, mesh=nccl_mesh).force(), x)
        ring = C.ring_all_gather_overlapped(x, axis, lambda s, slot: s + slot, mesh=nccl_mesh)
        assert len(ring) == 1 and torch.equal(ring[0], x)
        assert torch.equal(C.reduce_scatter_then_all_gather(x, axis, mesh=nccl_mesh).force(), x)
        red, err = C.pod_allreduce_compressed({"g": x.float()}, axis, None, mesh=nccl_mesh)
        q, want_err = compress_decompress({"g": x.float()}, None)
        assert torch.equal(red["g"], q["g"].to(torch.bfloat16).float())
        assert torch.equal(err["g"], want_err["g"])
    assert K.LAUNCHES == {op: 0 for op in K.OPS}


@pytest.mark.parametrize("attn_impl", ["dense", "chunked"])
@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "qwen1.5-4b", "olmo-1b",
                                  "internlm2-20b", "qwen3-32b", "llama4-maverick-400b-a17b",
                                  "moonshot-v1-16b-a3b", "llama-3.2-vision-90b", "mamba2-1.3b",
                                  "musicgen-medium"])
def test_remesh_state_and_sharded_restore_on_the_card(nccl_mesh, tmp_path, arch, attn_impl):
    """Every zoo arch's smoke params laid out by TRAIN_RULES on the
    one-rank mesh (DTensors on cuda), written by the checkpointer and
    restored into that template; then one sharded fp32 step under the
    mesh equal, bitwise, to the unsharded step (the card's torch lacks
    DTensor strategies the CPU's has: the hooks' pins cover them)."""
    from repro_torch import pytree as P
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.parallel import sharding as SH
    from repro_torch.train import AdamWConfig, Checkpointer, TrainConfig, init_opt_state
    from repro_torch.train import make_train_step
    from repro_torch.train.elastic import remesh_state

    cfg = smoke_config(get_config(arch)).with_overrides(dtype=torch.float32)
    layout = T.model_layout(cfg)
    params = init_params(layout, seed=0, device="cuda")
    dparams = remesh_state(params, layout, SH.TRAIN_RULES, nccl_mesh)
    specs = SH.param_pspecs(layout, SH.TRAIN_RULES, nccl_mesh)
    for d, p, s in zip(P.leaves(dparams), P.leaves(params), P.leaves(specs)):
        assert SH.is_dtensor(d) and d.to_local().is_cuda and torch.equal(d.to_local(), p)
        assert tuple(d.placements) == SH.placements(s, nccl_mesh)
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(3, {"params": dparams}, blocking=True)
    restored, step = ckpt.restore({"params": dparams})
    assert step == 3 and all(
        SH.is_dtensor(a) and a.placements == b.placements and torch.equal(a.to_local(), b.to_local())
        for a, b in zip(P.leaves(restored), P.leaves({"params": dparams})))

    ocfg = AdamWConfig(learning_rate=1e-3, eps=1e-3, warmup_steps=1, total_steps=4)
    tcfg = TrainConfig(num_microbatches=2, attn_impl=attn_impl, q_chunk=8, kv_chunk=8)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 17)))
    batch = {"tokens": toks[:, :-1].cuda(), "labels": toks[:, 1:].cuda()}
    gen = _gen(5)
    if cfg.embeds_input:
        batch["embeds"] = torch.randn((4, 16, cfg.d_model), generator=gen, device="cuda")
    if cfg.vision_tokens:
        batch["vision_embeds"] = torch.randn((4, cfg.vision_tokens, cfg.d_model),
                                             generator=gen, device="cuda")
    torch.use_deterministic_algorithms(True)
    try:
        plain = make_train_step(cfg, tcfg, ocfg)(params, init_opt_state(params, ocfg), batch)
        with SH.set_mesh(nccl_mesh):
            sharded = make_train_step(cfg, tcfg, ocfg, param_pspecs=specs)(
                dparams, init_opt_state(dparams, ocfg), batch)
    finally:
        torch.use_deterministic_algorithms(False)
    local = [x.to_local() if SH.is_dtensor(x) else x for x in P.leaves(sharded[:2])]
    assert all(torch.equal(a, b) for a, b in zip(local, P.leaves(plain[:2])))
    loss = sharded[2]["loss"]
    assert torch.equal(loss.to_local() if SH.is_dtensor(loss) else loss, plain[2]["loss"])
    assert K.LAUNCHES == {op: 0 for op in K.OPS}


# ---------------------------------------------------------------------------
# launch/pipeline_demo: the pipelined step across a one-rank pod axis (four
# gloo ranks check hops across ranks on the CPU, tests/test_torch_pipeline_demo.py)
# ---------------------------------------------------------------------------


@pytest.fixture
def nccl_pod():
    """A one-rank ``pod`` mesh over a one-rank NCCL group on cuda:0."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_mesh((1,), ("pod",))
    finally:
        dist.destroy_process_group()


def test_size_one_ring_hop_is_the_value(nccl_pod):
    from repro_torch.core.future import ring_hop_future

    x = torch.randn((4, 33), generator=_gen(6), device="cuda").requires_grad_(True)
    y = ring_hop_future(x, "pod", mesh=nccl_pod).force()
    assert y is x
    (g,) = torch.autograd.grad((y * 3).sum(), [x])
    assert torch.equal(g, torch.full_like(x, 3.0))


@pytest.mark.parametrize("schedule,interleave,backward", [
    ("gpipe", 1, "autodiff"), ("interleaved", 2, "autodiff"), ("one_f_one_b", 1, "planned"),
    ("interleaved", 2, "planned")])
def test_pipelined_demo_step_on_the_card_equals_lazy(nccl_pod, schedule, interleave, backward):
    """The demo step (qwen3-32b's smoke config, 4 layers, fp32, 16 x 32
    tokens in 8 microbatches) across the one-rank pod axis in 2 stages,
    bitwise the Lazy step's, under deterministic algorithms."""
    from repro_torch import pytree as P
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.core.pipeline import local_stages
    from repro_torch.launch import pipeline_demo as PD
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    cfg = smoke_config(get_config("qwen3-32b")).with_overrides(
        num_layers=4, dtype=torch.float32, kernels="plain")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (16, 33)))
    batch = {"tokens": toks[:, :-1].cuda(), "labels": toks[:, 1:].cuda()}

    def start():
        params = init_params(T.model_layout(cfg), seed=0, device="cuda")
        return dict(params, blocks=PD.stage_params(params["blocks"], 2))

    tcfg = PD._train_config(pipeline_schedule=schedule, pipeline_interleave=interleave,
                            pipeline_backward=backward)
    torch.use_deterministic_algorithms(True)
    try:
        want, want_loss = PD.make_pipelined_loss(cfg, nccl_pod, tcfg, 2, lazy=True)(
            start(), batch)
        params = start()
        params["blocks"] = local_stages(params["blocks"], tcfg.pipeline_config(2), nccl_pod)
        got, loss = PD.make_pipelined_loss(cfg, nccl_pod, tcfg, 2)(params, batch)
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.isfinite(loss) and torch.equal(loss, want_loss)
    assert all(torch.equal(a, b) for a, b in zip(P.leaves(got), P.leaves(want)))
    assert K.LAUNCHES == {op: 0 for op in K.OPS}


# ---------------------------------------------------------------------------
# serve/supervisor: a ranked StreamEngine under ServeSupervisor on a one-rank
# NCCL group (four gloo ranks check faults across ranks on the CPU,
# tests/test_torch_supervisor_ranks.py)
# ---------------------------------------------------------------------------


def test_supervisor_across_a_pod_rank_agrees_on_the_card(nccl_pod, monkeypatch):
    """The narrow OLMo (kernels="cuda") through ``StreamEngine(mesh=)`` on
    the one-rank pod axis, under ``ServeSupervisor`` with ``raise@1``:
    the unsupervised run's tokens, 0 requests lost, one replay, and every
    agreement an all-gather of tensors on the card (NCCL takes no CPU
    tensor)."""
    import torch.distributed as dist

    from repro_torch.configs.base import DecodePipelineConfig
    from repro_torch.serve.engine import ServeConfig, StreamEngine
    from repro_torch.serve.supervisor import ServeSupervisor, chaos_injector

    cfg, params = _serving_model("olmo-1b")
    scfg = ServeConfig(max_batch=4, max_len=256, prefill_chunk=16, max_new_tokens=7)
    pcfg = DecodePipelineConfig(num_cells=4, microbatches=2, round_steps=3, admit_per_round=2,
                                kernels="cuda")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 1024, size=n) for n in [5, 40, 17, 64, 3, 30]]
    budgets = [7, 3, 5, 6, 2, 7]

    def serve(server):
        reqs = [server.submit(p, b) for p, b in zip(prompts, budgets)]
        server.run_until_drained()
        assert all(r.done and r.status == "ok" for r in reqs)
        return [r.out_tokens for r in reqs]

    want = serve(StreamEngine(params, cfg, scfg, pcfg, mesh=nccl_pod, device="cuda"))
    devices = []
    all_gather = dist.all_gather

    def recorded(out, t, *args, **kw):
        devices.append(t.device.type)
        return all_gather(out, t, *args, **kw)

    monkeypatch.setattr(dist, "all_gather", recorded)
    sup = ServeSupervisor(StreamEngine(params, cfg, scfg, pcfg, mesh=nccl_pod, device="cuda"),
                          fail_injector=chaos_injector("raise", 1))
    assert serve(sup) == want
    assert sup.stats["restarts"] == 1 and sup.stats["requests_lost"] == 0, sup.stats
    assert "rank 0 exception: InjectedFault" in sup.events[0]["error"]
    assert len(devices) >= 2 * sup.stats["rounds"] and set(devices) == {"cuda"}
