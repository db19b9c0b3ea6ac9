#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Setup: TF32 off, the card's name and power limit (``nvidia-smi``), the
   CUDA kernels built from ``src/repro_torch/kernels/csrc`` into
   ``build/kernels`` (one ``nvcc`` per source, all started together).
2. Kernel phase: each kernel against its plain PyTorch version on the
   card at full width, in bf16 and fp32, with its time, the plain
   version's time, one library call's time (a yardstick the port never
   calls) and the least time the card could take (``bound_ms``).  The
   emit runs OLMo-1B's, Mamba2-1.3B's and Moonlight-16B-A3B's heads in
   both dtypes and the zoo's other untied heads (qwen3-32b,
   llama-3.2-vision, musicgen) in bf16; its ``kernels`` entry carries
   Moonlight's untied case under ``untied``.  Flash attention also runs
   llama-3.2-vision's cross-attention (B 8, Sq 1 and 128, 1601 keys, 64
   heads over 8 KV heads, non-causal, both dtypes; the Sq 1 bf16 case is
   its entry's ``cross``) and a musicgen-medium chunk (24 heads of 64);
   decode attention musicgen's 24 x 64 MHA; RMSNorm d 1536 and 8192.
   The emit also runs OLMo-1B's tied and Moonlight's untied head at B 128
   and 256 in both dtypes: past the rows one launch holds, the batch is
   tiled over launches (``emit_tiles``), each reading the head once.
3. Engine phase: full-width OLMo-1B (random weights from a seed) served
   through ``Engine``: 12 ragged requests through 8 slots, once with
   ``attn_impl="dense"`` and once with ``"flash"``; the launch counters,
   zeroed before each run, show that every decode step went through the
   decode-attention and emit kernels and, under ``"flash"``, every
   prefill chunk through the flash-attention kernel.
4. End-to-end checks: one decode state stepped with the kernels and with
   ``kernels="plain"`` on copies of the same cache; one prefill chunk at
   ``pos = 128`` with ``attn_impl="flash"`` and ``"dense"`` on copies of
   the same cache.
5. StreamEngine phase: the same 12 requests through ``StreamEngine``
   (``attn_impl="flash"``, ``kernels="cuda"``), every round's
   ``collect`` under ``torch.cuda.set_sync_debug_mode("error")``: a,
   Lazy with 4 cells and 1 microbatch (B = 8, as the Engine's step),
   whose tokens must equal the greedy ``"flash"`` Engine run's; b, Lazy
   with 8 cells and 4 microbatches; c, d, e, the ``FutureEvaluator`` on
   4 stage streams under gpipe, one_f_one_b and interleaved (2 virtual
   stages a stage), each identical to b; f, c at temperature 0.9 (seed
   11), twice, the two identical.  Each run's launch counters show the
   decode-attention kernel once per decoded item and layer, the emit
   once per emitted item and flash attention once per prefill call and
   layer; each round's peak memory stays below the memory before it
   plus its admission payload and one cell's cache shard.
6. Mamba2-1.3B at full width (48 blocks, random weights from a seed),
   after OLMo's weights are freed: the same 12 requests through
   ``Engine`` with 256-token prefill chunks; the counters show every
   prefill call through the SSD kernel once per layer, every prefill
   call and decode step through the RMSNorm kernel twice per layer (the
   block's pre-norm, and its gated norm with the gate fused), every
   decode step through the emit kernel.  Then a prefill chunk, a ragged
   tail and a decode step with the kernels against ``kernels="plain"``.
7. Moonlight-16B-A3B at full width and depth (48 layers, 64 experts
   top-6 + 2 shared, untied V 163840; random weights from seed 0, 57.8
   GB in bf16), after Mamba's weights are freed: the build's peak memory
   (the large expert stacks drawn a slice at a time) must leave room for
   the 3.2 GB cache; the 12 requests through ``Engine`` (``"flash"``,
   ``kernels="cuda"``), whose counters show decode attention once per
   decode step and layer, the untied emit once per decode step, flash
   attention once per prefill call and layer and RMSNorm twice per decode
   step or prefill call and layer; a decode step kernels vs plain and a
   prefill chunk at ``pos = 128`` flash vs dense, as in step 4 (the fp32
   runs upcast one layer group at a time: fp32 weights would take 115
   GB), with every layer's routes (``expert_ids``, ``keep``) held to the
   plain path's; layer 0's ``moe_apply`` on 8 and on 128 tokens, 20
   calls bitwise equal with no host sync; the StreamEngine, each round
   under the sync guard, Lazy with 4 cells and 1 microbatch (the
   Engine's tokens), then, on the first 8 layers, Lazy with 8 cells and
   4 microbatches, and Future on 4 stage streams (gpipe) with the same
   cells and microbatches (the Lazy run's tokens).
8a. llama-3.2-vision-90b at every published width, cut to 20 layers (4
   groups of its period: 16 self-attention and 4 cross-attention layers,
   38.4 GB in bf16; random weights from seed 0, every cross-attention gate
   set to a seeded nonzero value, since ``init_params``' zeros make a
   cross block add 0): the build's peak memory; the 12 requests through
   ``Engine`` (``"flash"``, no vision embeds, as the JAX engines serve
   it), whose counters show decode attention once per decode step and
   self-attention layer, flash attention once per prefill call and layer
   and once per decode step and cross-attention layer (Sq 1 over the
   1601 vision keys), RMSNorm twice per call and layer, the emit once per
   decode step; a decode step and a prefill call as one CUDA graph; a
   prefill chunk at 0 with fresh vision embeds (B 8, 1601 x 8192), a chunk
   at 128 reading the vision K/V it cached and a decode step, kernels
   against plain in fp32 and bf16, the cached vision K/V included; the
   StreamEngine a (Lazy, 4 cells, 1 microbatch: the Engine's tokens), b
   (Lazy, 4 cells, 4 microbatches) and c (b under Future on 4 stage
   streams, gpipe: b's tokens).
8b. musicgen-medium whole (48 layers, d 1536, frame embeddings in place
   of tokens): ``forward``, a chunked ``prefill_step`` of 8 x 600 frames
   and 32 decode steps, kernels against plain in fp32 and bf16, with
   exact launches (the engines serve token-input archs only).
9. Stream phase: the paper's two algorithms under the port's
   ``LazyEvaluator`` on the card, each ``collect`` (and the work around
   it that stays on the card) under ``torch.cuda.set_sync_debug_mode
   ("error")``, so that a cell which syncs with the host fails: the
   sieve at the paper's ``primes`` (limit 20000, 256-wide blocks, 16
   primes a cell: 2262 primes, against Eratosthenes), then at limit
   5000 (669 primes, 48 cells; cut from 20000 in PR 27 to keep the
   script inside its limit) under the Lazy evaluator and the
   ``FutureEvaluator`` on 4 stage streams, equal to each other, with the
   stages' overlap from events around every unit;
   Fateman's
   (1+x+y+z)^20 squared (12341 terms) through ``times`` (4 x-chunks, 8
   terms a cell) and ``times_dense``, at 12 limbs with the factor
   100000000001 (``stream_big``, against the exact product) and at 4
   limbs (``stream``, against the exact product mod 2^52), the 4-limb
   product again under the ``FutureEvaluator`` (224 cells), equal to
   the Lazy one; and a
   ``defer``-ed computation on the side stream, forced on the current
   stream while other work runs there, against the same computation run
   directly (bitwise).

10. Training at full width and depth: OLMo-1B (16 layers, 1,176,764,416
   parameters in bf16, random from seed 0).  a, ``make_train_step``
   refuses ``kernels="cuda"`` and the kernel guard stops a forward under
   autograd with ``kernels="cuda"``; b, 20 AdamW steps (lr 3e-4, 5 warmup
   steps) of 8 x 2048 synthetic tokens in 2 microbatches, remat, chunked
   attention: finite losses, the last five at least 0.5 nat below step
   1's, step p50, tokens/s, peak memory; c, ``ResilientLoop`` over 10
   steps with a checkpoint every 4 and a fault at step 6, against a
   fault-free 10-step run from the same start, bitwise, under
   ``torch.use_deterministic_algorithms(True)`` (``CUBLAS_WORKSPACE_CONFIG``
   is set before CUDA starts); d, ``pipeline_apply`` over the 16 layers
   (4 microbatches of 2 x 2048, bf16, remat) under Lazy, Future on 4
   stage streams with ``backward="autodiff"`` and with ``"planned"``,
   one_f_one_b (4 stages of 4 layers) and interleaved (8 of 2): outputs
   and gradients bitwise equal, peak memory beside the stash bound, the
   stages' overlap.  The launch counters read 0 throughout: training
   runs the plain ops.

11. Roofline and trace (``repro_torch.roofline``), run where each model is
   already built: a, the card's attainable rates (a 4 GiB device copy,
   a bf16 8192^3 matmul) beside the datasheet peaks the bounds use (a
   reading above 105 % of its peak fails); b, after the kernel phase's
   OLMo-1B runs, 16 steady decode steps of the ``Engine`` under
   ``torch.profiler``: the idle share, the 10 longest idle gaps with the
   host op that held each, the top 10 kernels, launches a step from the
   trace equal to the launch counters (decode attention 16, the tied
   emit 1), no slab-sized cache copy, and device busy a step at least
   0.95 of ``predicted_tick_seconds``; c, one round of StreamEngine c,
   whose emit must run on the final stage's stream only; d, in step 7,
   4 eager decode steps of Moonlight's ``Engine`` (decode attention 48,
   the untied emit 1, RMSNorm 96 a step); e, in step 10, one step of the
   train loop (no kernel launched).  The kernel phase's bounds come from
   ``roofline/analytic.py``.

12. The mesh layer on a one-rank NCCL process group over ``cuda:0`` and a
   (data 1, model 1) ``DeviceMesh`` (NCCL refuses two ranks on one GPU,
   so no collective across ranks is checked here; four gloo ranks check
   them on the CPU): a, the collective futures and helpers on cuda
   tensors, each bitwise its size-one result, and a forced future
   ordering the stream with no host sync; b, step 10c's last checkpoint
   of OLMo-1B restored into a template sharded by ``TRAIN_RULES`` on the
   mesh of ``choose_elastic_plan(1)``, then 2 sharded steps under the
   mesh against 2 unsharded ones from the same state, losses and every
   leaf bitwise equal, with step p50 and peak memory; the plans for 512,
   256 and 128 devices; c, the dry run of every cell on both production
   mesh shapes (analytic counts, not card readings).  No kernel launches.

13. ``launch/pipeline_demo`` on step 12's one-rank NCCL group, over a
   one-rank ``pod`` mesh: a, ``ring_hop_future`` is the value itself and
   issues no p2p, and a forced hop future returns to the host behind 50
   ms of queued work; b, qwen3-32b at every published width cut to 4
   layers (fp32, 3,506,223,104 parameters, random from seed 0), the
   demo's train step on 16 x 512 tokens in 8 microbatches: 2 Lazy steps,
   then 2 steps each across the pod axis under gpipe, interleaved (2
   virtual stages) and one_f_one_b with the planned backward, losses and
   every leaf bitwise the Lazy steps', with step p50 and peak memory; c,
   ``pipeline_demo.main()``'s record of qwen3-32b x train_4k on the
   2x16x16 mesh (analytic).  No kernel launches.

14. ``FutureEvaluator(mesh=)`` on step 12's one-rank NCCL group, over a
   one-rank ``pod`` mesh: a, full-width OLMo-1B (built again from seed 0)
   served through ``StreamEngine(mesh=)``, each round under the sync
   guard: 4 cells and 1 microbatch, the greedy flash Engine's tokens; 8
   cells and 4 microbatches of 2 under gpipe and under interleaved (2
   virtual stages), run b's tokens and b's decode-attention, emit and
   flash launches; c, the 4-cell, 1-microbatch run under
   ``ServeSupervisor`` (every attempt agreed over the NCCL group):
   fault-free with the snapshot's cost beside step 5b's, then raise@2,
   nan@3, wedge@1 and sigterm@4, each with 0 requests lost, the greedy
   flash Engine's tokens and launches equal to the calls made, replays
   included; b, the sieve at limit 5000 (669 primes) and the 4-limb
   Fateman product across the axis, each bitwise step 9's Lazy run.
   About 75 s.

Step 3 also serves OLMo-1B with ``"flash"`` at temperature 0.9 (seed
11), twice: the two runs must give the same tokens (the sampling key is
a function of seed, request and token index), with the launch counts of
the greedy ``"flash"`` run's formula.

Any failure exits non-zero.  The line before the last is the ``kernels``
JSON record; the last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the repository beside it, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# The training phase's fault replay runs under
# torch.use_deterministic_algorithms(True), which needs cuBLAS's
# deterministic workspace, set before CUDA is first touched.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

REPS = 21


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def device_ms(calls, reps: int = REPS) -> float:
    """Device time of one call, in ms: ``calls`` (closures of the same
    function on different copies of its inputs, together larger than the
    50 MB L2, so that every call finds its inputs cold as the decode loop
    does) are captured once into a CUDA graph; the median over ``reps``
    replays between two CUDA events, divided by ``len(calls)``.  The
    graph removes the host's launch cost, which eager timing would add
    wherever it exceeds the device time.  The calls are warmed up on the
    side stream they are then captured on, which gives the attention
    kernels that stream's merge tickets before the capture (none is
    allocated while capturing)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    del graph
    return statistics.median(s.elapsed_time(e) for s, e in pairs) / len(calls)


def eager_ms(fn, reps: int = REPS) -> float:
    """Time of one eager call as the host issues it (launch cost
    included), in ms: ``reps`` calls back to back between two events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bf16_ulp(x):
    import torch

    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def row_max(x):
    """Each row's largest |x|, kept as a column."""
    return x.abs().amax(dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# Kernel phase
# ---------------------------------------------------------------------------

# Decode attention: outputs are convex combinations of order-1 values,
# rounded once to the output dtype.  The kernel's online softmax and the
# plain version's two-pass softmax round differently in fp32, which can
# move that one bf16 rounding: bf16 atol = rtol = 1.6e-2 (2 bf16 ulps at
# magnitude 1); fp32 atol = rtol = 1e-5 (sums of 1024 terms in another
# order).
DECODE_TOL = {"bfloat16": 1.6e-2, "float32": 1e-5}


def decode_case(gen, b, s, h, kv, dh, dtype, pos):
    import torch

    dev = "cuda"

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    q, kn, vn = rnd(b, 1, h, dh), rnd(b, kv, dh), rnd(b, kv, dh)
    kc, vc = rnd(b, s, kv, dh), rnd(b, s, kv, dh)
    pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    kv_len = pos + 1
    # Row 0 is a fresh admission (pos 0) over a poisoned cache: NaN in K
    # beyond kv_len (masked before the softmax) and 1e4 in V (multiplied
    # by an exact 0 in the plain version; a NaN there would make the plain
    # version itself NaN).
    kc[0, 1:] = float("nan")
    vc[0, 1:] = 1e4
    return (q, kn, vn, kc, vc), pos, kv_len


def run_decode_attention(gen, results):
    import torch
    import torch.nn.functional as F

    from repro_torch import kernels as K
    from repro_torch.kernels.decode_attention.ops import decode_split, fused_decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.roofline.analytic import bound_ms, decode_attention_work

    b, s, copies = 8, 1024, 4
    sms = K.sm_count(torch.device("cuda"))
    pos = [0, s - 1, 517, 128, 64, 900, 1000, 3]
    main = None
    for label, h, kv, dh in (("olmo-1b", 16, 16, 128), ("qwen3-32b GQA", 64, 8, 128),
                             ("musicgen-medium MHA", 24, 24, 64)):
        for dtype in (torch.bfloat16, torch.float32):
            cases = [decode_case(gen, b, s, h, kv, dh, dtype, pos) for _ in range(copies)]
            args, p, n = cases[0]
            got = fused_decode_attention(*args, pos=p, kv_len=n)
            want = decode_attention_ref(*args, pos=p, kv_len=n)
            torch.cuda.synchronize()
            tol = DECODE_TOL[str(dtype).removeprefix("torch.")]
            err = (got.float() - want.float()).abs()
            rel = (err / want.float().abs().clamp_min(1e-6)).max().item()
            ok = bool(torch.isfinite(got.float()).all()) and bool(
                (err <= tol + tol * want.float().abs()).all())
            kernel = [lambda c=c: fused_decode_attention(*c[0], pos=c[1], kv_len=c[2])
                      for c in cases]
            plain = [lambda c=c: decode_attention_ref(*c[0], pos=c[1], kv_len=c[2])
                     for c in cases]
            ms, plain_ms = device_ms(kernel), device_ms(plain)
            host_ms = eager_ms(kernel[0])
            # yardstick: SDPA over each copy's updated cache, (B, H, S, dh) views
            idx = torch.arange(b, device="cuda")
            sdpa_kw = {"enable_gqa": True} if h != kv else {}
            library = []
            for (q, kn, vn, kc, vc), p_, n_ in cases:
                kc[idx, p_.long()] = kn  # the copies are not needed any more
                vc[idx, p_.long()] = vn
                mask = (torch.arange(s, device="cuda")[None, :] < n_[:, None])[:, None, None, :]
                library.append(lambda q=q, kc=kc, vc=vc, mask=mask: F.scaled_dot_product_attention(
                    q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
                    attn_mask=mask, **sdpa_kw))
            lib_ms = device_ms(library)
            rows = n.clamp(max=s).sum().item()
            bms, by = bound_ms(*decode_attention_work(b, h, kv, dh, rows, args[0].element_size()),
                               dtype)
            split_rows, splits = decode_split(b, kv, s, sms)
            print(f"decode_attention {label} B={b} S={s} H={h} KV={kv} dh={dh} {dtype} "
                  f"(valid rows {rows}): max_abs_err={err.max().item():.3e} "
                  f"max_rel_err={rel:.3e} tol={tol:g} {'ok' if ok else 'FAILED'}; device "
                  f"kernel {ms:.4f} ms (eager call {host_ms:.4f} ms), plain {plain_ms:.4f} ms, "
                  f"sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}; bound/kernel "
                  f"{bms / ms:.3f}); {splits} splits of {split_rows} rows", flush=True)
            if not ok:
                fail(f"decode_attention {label} {dtype} disagrees with its plain version")
            if main is None:
                main = dict(max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms,
                            bound_ms=bms, bound_by=by, library_ms=lib_ms)
            del cases, kernel, plain, library
    results["decode_attention"] = main


def emit_errors(got, want, dtype):
    """Tolerance per row, scaled by the row's largest |logit|: an element
    of the normalised x may round to bf16 one ulp apart on the two sides,
    which moves a logit by an amount of the order of the row's scale, and
    each logit is then rounded to x's dtype.  bf16: 2 bf16 ulps of the
    row's largest |logit|; fp32: 1e-4 of it (d = 2048 products summed in
    another order)."""
    import torch

    top = want.abs().amax(dim=-1, keepdim=True)
    allowed = 2 * bf16_ulp(top) if dtype == torch.bfloat16 else 1e-4 * top
    err = (got - want).abs()
    return err, bool((err <= allowed).all()), (err / allowed).max().item()


# (norm, tied, V, d, dtypes) of the emit phase: OLMo-1B's own case
# (layernorm, tied, V 50304) first, as the ``kernels`` record's; Mamba2-
# 1.3B's (rmsnorm, tied, V 50280) second; Moonlight-16B-A3B's (rmsnorm,
# untied, V 163840), the record's ``untied`` entry; then the zoo's other
# untied heads in bf16: qwen3-32b's, llama-3.2-vision's (d 8192) and
# musicgen's (V 2048: 32 groups of 64 columns, 32 SMs busy).
EMIT_CASES = (
    *[(norm, tied, v, 2048, ("bfloat16", "float32")) for norm, tied, v in (
        ("layernorm_nonparam", True, 50304), ("rmsnorm", True, 50280),
        ("layernorm_nonparam", False, 50304), ("rmsnorm", True, 50304),
        ("rmsnorm", False, 50304), ("rmsnorm", False, 163840))],
    ("rmsnorm", False, 151936, 5120, ("bfloat16",)),
    ("rmsnorm", False, 128256, 8192, ("bfloat16",)),
    ("rmsnorm", False, 2048, 1536, ("bfloat16",)),
)
MOONLIGHT_EMIT = ("rmsnorm", False, 163840, 2048)
# Batches past one launch's rows (the emit tiles them over launches, each
# reading the head once): OLMo-1B's tied head and Moonlight-16B-A3B's
# untied head at B 128 and 256, in both dtypes
EMIT_WIDE = (("layernorm_nonparam", True, 50304, 2048), ("rmsnorm", False, 163840, 2048))
EMIT_WIDE_BATCHES = (128, 256)


def emit_case(gen, norm, tied, v, d, dtype, kernel, plain, b=8, eps=1e-5) -> dict:
    """One emit case on the card: ``kernel`` (a checkout's
    ``emit_norm_logits``) against ``plain`` on the same inputs, its device
    time, the plain version's, norm + matmul's (the library yardstick) and
    the bytes bound; prints one line and fails on disagreement."""
    import torch
    import torch.nn.functional as F

    from repro_torch.roofline.analytic import bound_ms, emit_work

    x = (torch.randn((b, 1, d), generator=gen, device="cuda") * 2 + 0.3).to(dtype)
    shape, std = ((v, d), 0.02) if tied else ((d, v), d**-0.5)
    w = (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)
    scale = (torch.randn((d,), generator=gen, device="cuda") * 0.2 + 1.0
             if norm == "rmsnorm" else None)
    kw = dict(norm=norm, scale=scale, eps=eps, tied=tied)
    from repro_torch import kernels as K

    before = K.LAUNCHES["emit_norm_logits"]
    got = kernel(x, w, **kw)
    launches = K.LAUNCHES["emit_norm_logits"] - before
    want = plain(x, w, **kw)
    torch.cuda.synchronize()
    err, ok, worst = emit_errors(got, want, dtype)
    rel = (err / want.abs().clamp_min(1e-6)).max().item()
    # every call finds its head cold: a head smaller than the L2 is timed
    # over copies that together exceed it twice
    heads = [w] + [w.clone() for _ in range(int(2 * L2_BYTES // w.nbytes))]
    ms = device_ms([lambda h=h: kernel(x, h, **kw) for h in heads])
    plain_ms = device_ms([lambda h=h: plain(x, h, **kw) for h in heads])
    host_ms = eager_ms(lambda: kernel(x, w, **kw))

    def library(h):
        xn = (F.layer_norm(x, (d,), eps=eps) if norm == "layernorm_nonparam"
              else F.rms_norm(x.float(), (d,), scale, eps=eps).to(dtype))
        return xn @ (h.T if tied else h)

    lib_ms = device_ms([lambda h=h: library(h) for h in heads])
    bms, by = bound_ms(*emit_work(b, d, v, x.element_size(), scaled=scale is not None), dtype)
    print(f"emit_norm_logits {norm} tied={tied} B={b} d={d} V={v} {dtype}: "
          f"{launches} launch{'es' if launches != 1 else ''} a call; "
          f"max_abs_err={err.max().item():.3e} max_rel_err={rel:.3e} "
          f"worst/allowed={worst:.3f} {'ok' if ok else 'FAILED'}; device kernel {ms:.4f} ms "
          f"(eager call {host_ms:.4f} ms), plain {plain_ms:.4f} ms, norm+matmul "
          f"{lib_ms:.4f} ms (kernel/library {ms / lib_ms:.3f}), bound {bms:.4f} ms ({by}, "
          f"{bms / ms:.3f} of it)", flush=True)
    if not ok:
        fail(f"emit_norm_logits {norm} tied={tied} V={v} d={d} {dtype} disagrees with its "
             f"plain version")
    return dict(max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms, launches_per_call=launches)


def run_emit(gen, results):
    import torch

    from repro_torch.kernels.emit_norm_logits.ops import emit_norm_logits, emit_tiles
    from repro_torch.kernels.emit_norm_logits.ref import emit_norm_logits_ref

    main, untied = None, {}
    for norm, tied, v, d, dtypes in EMIT_CASES:
        for name in dtypes:
            row = emit_case(gen, norm, tied, v, d, getattr(torch, name), emit_norm_logits,
                            emit_norm_logits_ref)
            if main is None:
                main = row
            if (norm, tied, v, d) == MOONLIGHT_EMIT:
                untied[name] = dict(row, kernel_over_library=row["ms"] / row["library_ms"])
    # past one launch's rows: tiled over launches, each reading the head
    # once (the bound counts it once)
    wide = {}
    for norm, tied, v, d in EMIT_WIDE:
        for b in EMIT_WIDE_BATCHES:
            for name in ("bfloat16", "float32"):
                dtype = getattr(torch, name)
                row = emit_case(gen, norm, tied, v, d, dtype, emit_norm_logits,
                                emit_norm_logits_ref, b=b)
                want = len(emit_tiles(b, d, dtype, tied))
                if row["launches_per_call"] != want:
                    fail(f"emit B={b} tied={tied} {name}: {row['launches_per_call']} launches, "
                         f"its tiling plan has {want}")
                wide[f"{'tied' if tied else 'untied'} B{b} {name}"] = row
    results["emit_norm_logits"] = dict(main, untied=untied, wide=wide)


# Flash attention: outputs are convex combinations of order-1 values.
# bf16: the kernel rounds P to bf16 for P.V on the tensor cores (the
# plain version keeps P in fp32), then rounds the output once; JAX's own
# tolerance for its flash kernel, atol = rtol = 2e-2.  fp32: sums of up
# to 2048 terms in another order, atol = rtol = 2e-5 (also JAX's).
FLASH_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
L2_BYTES = 50e6


def run_flash(gen, results):
    import torch
    import torch.nn.functional as F

    from repro_torch import kernels as K
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_split, key_span
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.roofline.analytic import bound_ms, flash_work

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # label, b, sq, sk, h, kv, dh, dtype, causal, q_offset, kv_len (None | int | per-row list)
        ("prefill chunk", 1, 128, 1024, 16, 16, 128, bf16, True, 0, 128),
        ("prefill chunk", 1, 128, 1024, 16, 16, 128, bf16, True, 128, 256),
        ("prefill chunk", 1, 128, 1024, 16, 16, 128, bf16, True, 512, 640),  # the record's case
        ("ragged kv_len", 4, 128, 1024, 16, 16, 128, bf16, True, 512, [640, 0, 300, 1024]),
        ("forward", 1, 2048, 2048, 16, 16, 128, bf16, True, 0, None),
        ("qwen3-32b GQA prefill chunk", 1, 128, 1024, 64, 8, 128, bf16, True, 512, 640),
        ("prefill chunk", 1, 128, 1024, 16, 16, 128, f32, True, 512, 640),
        # llama-3.2-vision's cross-attention over its 1601 vision tokens (not
        # a multiple of the 64-key tile), non-causal, every key valid: a
        # decode step's one query row (the record's ``cross`` entry) and a
        # prefill chunk's 128
        *[("llama-3.2-vision cross", 8, sq, 1601, 64, 8, 128, dt, False, 0, None)
          for sq in (1, 128) for dt in (bf16, f32)],
        ("musicgen-medium prefill chunk", 1, 128, 1024, 24, 24, 64, bf16, True, 512, 640),
    ]
    for label, b, sq, sk, h, kv, dh, dtype, causal, q_offset, kv_len in cases:
        elem = torch.tensor([], dtype=dtype).element_size()
        per_copy = elem * (2 * b * sq * h * dh + 2 * b * sk * kv * dh)
        copies = min(16, max(1, -(-int(1.3 * L2_BYTES) // per_copy)))  # together colder than L2

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)

        lens = (kv_len if isinstance(kv_len, int) or kv_len is None
                else torch.tensor(kv_len, dtype=torch.int32, device="cuda"))
        inputs = [(rnd(b, sq, h, dh), rnd(b, sk, kv, dh), rnd(b, sk, kv, dh)) for _ in range(copies)]
        kw = dict(causal=causal, q_offset=q_offset, kv_len=lens)
        got = flash_attention(*inputs[0], **kw)
        want = flash_attention_ref(*inputs[0], **kw)
        torch.cuda.synchronize()
        tol = FLASH_TOL[str(dtype).removeprefix("torch.")]
        err = (got.float() - want.float()).abs()
        ok = bool(torch.isfinite(got.float()).all()) and bool(
            (err <= tol + tol * want.float().abs()).all())
        kernel = [lambda a=a: flash_attention(*a, **kw) for a in inputs]
        plain = [lambda a=a: flash_attention_ref(*a, **kw) for a in inputs]
        ms, plain_ms = device_ms(kernel), device_ms(plain)
        host_ms = eager_ms(kernel[0])
        # yardstick: SDPA over the keys some query can see, with an explicit mask
        per_row = [sk] * b if kv_len is None else (
            [kv_len] * b if isinstance(kv_len, int) else list(kv_len))
        n = max(min(max(x, 0), sk) for x in per_row)
        key = torch.arange(n, device="cuda")
        mask = key[None, None, :] < torch.tensor(per_row, device="cuda")[:, None, None]
        if causal:
            mask = mask & (key[None, :] <= torch.arange(sq, device="cuda")[:, None] + q_offset)
        # (B, 1, Sq, n); none where every query sees every key (cross-attention)
        mask = None if not causal and kv_len is None else mask[:, None]
        sdpa_kw = {"enable_gqa": True} if h != kv else {}
        library = [lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
            q.transpose(1, 2), k[:, :n].transpose(1, 2), v[:, :n].transpose(1, 2),
            attn_mask=mask, **sdpa_kw) for q, k, v in inputs]
        lib_ms = device_ms(library)
        nbytes, ops = flash_work(b, sq, sk, h, kv, dh, causal, q_offset, per_row, elem)
        bms, by = bound_ms(nbytes, ops, dtype)
        span = key_span(sq, sk, causal=causal, q_offset=q_offset,
                        kv_len=None if isinstance(kv_len, list) else kv_len)
        block_rows, split_keys, splits = (
            flash_split(b, h, sq, span, K.sm_count(torch.device("cuda"))) if dtype == bf16
            else (64, sk, 1))
        print(f"flash_attention {label} B={b} Sq={sq} cache={sk} H={h} KV={kv} dh={dh} {dtype} "
              f"causal={causal} q_offset={q_offset} kv_len={kv_len}: "
              f"max_abs_err={err.max().item():.3e} tol={tol:g} {'ok' if ok else 'FAILED'}; "
              f"device kernel {ms:.4f} ms (eager call {host_ms:.4f} ms), plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}: {nbytes / 1e6:.2f} MB, "
              f"{ops / 1e9:.3f} GFLOP; bound/kernel {bms / ms:.3f}); {block_rows}-row blocks, "
              f"{splits} splits of {split_keys} keys", flush=True)
        if not ok:
            fail(f"flash_attention {label} {dtype} q_offset={q_offset} disagrees with its "
                 f"plain version")
        row = dict(max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms, bound_ms=bms,
                   bound_by=by, library_ms=lib_ms)
        if label == "prefill chunk" and q_offset == 512 and dtype == bf16:
            results["flash_attention"] = row
        if label == "llama-3.2-vision cross" and sq == 1 and dtype == bf16:
            cross = dict(row, kernel_over_library=ms / lib_ms)
        del inputs, kernel, plain, library
    results["flash_attention"]["cross"] = cross


# SSD intra-chunk kernel.  fp32: sums of up to 256 products in another
# order, and the chunk's cumsum scanned in another order: 1e-4.  bf16 y:
# the same fp32 value rounded once to bf16, which one fp32 ulp can move
# by one bf16 ulp: 2 bf16 ulps at magnitude 1, 1.6e-2.  state (fp32
# always) and cum: 1e-4.  The chunked SSD through the kernel against the
# naive recurrence: 2e-3, as the JAX package holds its Pallas kernel.
SSD_TOL = {"bfloat16": 1.6e-2, "float32": 1e-4}


def run_ssd(gen, results):
    import torch

    from repro_torch.kernels.ssd.ops import ssd_chunked_cuda, ssd_intra_chunk
    from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref, ssd_ref
    from repro_torch.roofline.analytic import bound_ms, ssd_bound_ms, ssd_work

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # label, bc, h, q, p, g, n, dtype
        ("mamba2-1.3b prefill chunk", 1, 64, 256, 64, 1, 128, bf16),  # the record's case
        ("mamba2-1.3b prefill chunk", 1, 64, 256, 64, 1, 128, f32),
        ("ragged tail", 1, 64, 37, 64, 1, 128, bf16),
        ("G=4", 1, 64, 256, 64, 4, 128, bf16),
    ]
    for label, bc, h, q, p, g, n, dtype in cases:
        elem = torch.tensor([], dtype=dtype).element_size()
        nbytes, cb_ops, head_ops = ssd_work(bc, h, q, p, g, n, elem)
        ops = cb_ops + head_ops
        copies = min(16, max(1, -(-int(1.3 * L2_BYTES) // nbytes)))  # together colder than L2

        def inputs():
            def rnd(*shape, scale=1.0):
                return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

            dt = torch.rand((bc, h, q), generator=gen, device="cuda") * 0.19 + 0.01
            a = -(torch.rand((h,), generator=gen, device="cuda") + 0.5)
            return (rnd(bc, h, q, p), dt, rnd(bc, g, q, n, scale=n**-0.5),
                    rnd(bc, g, q, n, scale=n**-0.5), a,
                    torch.randn((h,), generator=gen, device="cuda"))

        args = [inputs() for _ in range(copies)]
        got = ssd_intra_chunk(*args[0])
        want = ssd_intra_chunk_ref(*args[0])
        torch.cuda.synchronize()
        tol = SSD_TOL[str(dtype).removeprefix("torch.")]
        errs = [(g_.float() - w_.float()).abs() for g_, w_ in zip(got, want)]
        ok = all(bool(torch.isfinite(g_.float()).all()) for g_ in got) and all(
            bool((e <= t + t * w_.float().abs()).all())
            for e, w_, t in zip(errs, want, (tol, 1e-4, 1e-4)))
        ms = device_ms([lambda a=a: ssd_intra_chunk(*a) for a in args])
        plain_ms = device_ms([lambda a=a: ssd_intra_chunk_ref(*a) for a in args])
        host_ms = eager_ms(lambda: ssd_intra_chunk(*args[0]))
        bms, by = ssd_bound_ms(nbytes, cb_ops, head_ops, dtype)
        cuda_core_ms, _ = bound_ms(nbytes, ops, torch.float32)
        print(f"ssd {label} BC={bc} H={h} Q={q} P={p} G={g} N={n} {dtype}: max_abs_err y "
              f"{errs[0].max().item():.3e} state {errs[1].max().item():.3e} cum "
              f"{errs[2].max().item():.3e} tol={tol:g} {'ok' if ok else 'FAILED'}; device kernel "
              f"{ms:.4f} ms (eager call {host_ms:.4f} ms), plain {plain_ms:.4f} ms, library none, "
              f"bound {bms:.4f} ms ({by}: {nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP "
              f"fp32-accurate on the tensor cores; {cuda_core_ms:.4f} ms at the fp32 CUDA-core "
              f"rate)", flush=True)
        if not ok:
            fail(f"ssd {label} {dtype} disagrees with its plain version")
        if "ssd" not in results:
            results["ssd"] = dict(max_abs_err=errs[0].max().item(), ms=ms, plain_ms=plain_ms,
                                  bound_ms=bms, bound_by=by, library_ms=None)
        del args, got, want

    # the chunked SSD through the kernel against the naive recurrence, fp32
    b, s, h, p, g, n = 1, 512, 64, 64, 1, 128
    x = torch.randn((b, s, h, p), generator=gen, device="cuda")
    dt = torch.rand((b, s, h), generator=gen, device="cuda") * 0.19 + 0.01
    a = -(torch.rand((h,), generator=gen, device="cuda") + 0.5)
    bm, cm = (torch.randn((b, s, g, n), generator=gen, device="cuda") * n**-0.5
              for _ in range(2))
    d_skip = torch.randn((h,), generator=gen, device="cuda")
    s0 = torch.randn((b, h, n, p), generator=gen, device="cuda")
    ry, rs = ssd_ref(x, dt, a, bm, cm, d_skip, initial_state=s0)
    for recurrence in ("scan", "associative"):
        y, final = ssd_chunked_cuda(x, dt, a, bm, cm, d_skip, chunk=256, initial_state=s0,
                                    recurrence=recurrence)
        torch.cuda.synchronize()
        ey = ((y - ry).abs() / (1 + ry.abs())).max().item()
        es = ((final - rs).abs() / (1 + rs.abs())).max().item()
        ok = ey <= 2e-3 and es <= 2e-3
        print(f"ssd_chunked_cuda recurrence={recurrence} B={b} S={s} H={h} chunk 256 fp32 vs "
              f"the naive recurrence: max err/(1+|ref|) y {ey:.3e} state {es:.3e} tol 2e-3 "
              f"{'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            fail(f"ssd_chunked_cuda recurrence={recurrence} disagrees with ssd_ref")


# RMSNorm: the same fp32 value rounded once to x's dtype; the fp32 sum of
# squares in another order and rsqrtf move it by an fp32 ulp or two,
# which can move the bf16 rounding by one bf16 ulp (2**-7 relative).
RMS_TOL = {"bfloat16": (1e-5, 2**-7), "float32": (1e-6, 1e-5)}
# (rows, d): a decode step's 8 rows and a 256-token prefill chunk's, at
# Mamba2-1.3B's gated norm (d_inner 4096) and block pre-norm (d 2048);
# a decode step's 8 rows and a 128-token chunk's at musicgen-medium's d
# 1536 and llama-3.2-vision's d 8192
RMS_SHAPES = ((8, 4096), (256, 4096), (8, 2048), (256, 2048), (8, 1536), (128, 1536),
              (8, 8192), (128, 8192))


def run_rmsnorm(gen, results):
    """Every (rows, d) of ``RMS_SHAPES`` in bf16 and fp32, ungated and
    gated; z is the column slice of an in_proj output (Mamba2's row of
    2 d + 2 * 128 + d / 64 elements), read in place.  Beside the kernel:
    its plain version, and ``F.rms_norm`` (ungated) or the unfused
    sequence silu, cast, multiply, ``F.rms_norm`` (gated).  The record is
    the gated 8 x 4096 bf16 norm of a decode step, the costlier of its two
    launches a block; no one PyTorch call computes it (library_ms null)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.roofline.analytic import bound_ms, rmsnorm_work

    eps = 1e-5
    for rows, d in RMS_SHAPES:
        width = 2 * d + 2 * 128 + d // 64
        for dtype in (torch.bfloat16, torch.float32):
            for gated in (False, True):
                elem = torch.tensor([], dtype=dtype).element_size()
                nbytes, work = rmsnorm_work(rows, d, elem, gated=gated)
                copies = min(64, max(1, -(-int(1.3 * L2_BYTES) // nbytes)))
                ys = [(torch.randn((rows, d), generator=gen, device="cuda") * 2 + 0.3).to(dtype)
                      for _ in range(copies)]
                zs = [(torch.randn((rows, width), generator=gen, device="cuda") * 2).to(dtype)[:, :d]
                      if gated else None for _ in range(copies)]
                scale = torch.randn((d,), generator=gen, device="cuda") * 0.2 + 1
                cases = list(zip(ys, zs))
                got = ops.rmsnorm(ys[0], scale, eps, gate=zs[0])
                want = rmsnorm_ref(ys[0], scale, eps, gate=zs[0])
                torch.cuda.synchronize()
                atol, rtol = RMS_TOL[str(dtype).removeprefix("torch.")]
                err = (got.float() - want.float()).abs()
                ok = bool(torch.isfinite(got.float()).all()) and bool(
                    (err <= atol + rtol * want.float().abs()).all())
                ms = device_ms([lambda y=y, z=z: ops.rmsnorm(y, scale, eps, gate=z)
                                for y, z in cases])
                plain_ms = device_ms([lambda y=y, z=z: rmsnorm_ref(y, scale, eps, gate=z)
                                      for y, z in cases])
                w = scale.to(dtype)  # F.rms_norm takes its weight in x's dtype

                def gate_ops(y, z):  # what the gate cost in plain ops before the fusion
                    return y if z is None else y * F.silu(z.float()).to(dtype)

                lib_ms = device_ms([lambda y=y, z=z: F.rms_norm(gate_ops(y, z), (d,), w, eps)
                                    for y, z in cases])
                host_ms = eager_ms(lambda: ops.rmsnorm(ys[0], scale, eps, gate=zs[0]))
                bms, by = bound_ms(nbytes, work, dtype)
                lib_name = "silu+cast+mul+F.rms_norm" if gated else "F.rms_norm"
                line = (f"rmsnorm rows={rows} d={d} {dtype} gated={gated}: max_abs_err="
                        f"{err.max().item():.3e} {'ok' if ok else 'FAILED'}; device kernel "
                        f"{ms:.4f} ms (eager call {host_ms:.4f} ms), plain "
                        f"{plain_ms:.4f} ms, {lib_name} {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}; "
                        f"bound/kernel {bms / ms:.3f})")
                print(line, flush=True)
                if not ok:
                    fail(f"rmsnorm rows={rows} d={d} {dtype} gated={gated} disagrees with its "
                         f"plain version")
                if (rows, d, dtype, gated) == (8, 4096, torch.bfloat16, True):
                    results["rmsnorm"] = dict(max_abs_err=err.max().item(), ms=ms,
                                              plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                                              library_ms=None)
                del ys, zs, cases


# ---------------------------------------------------------------------------
# Engine phase and end-to-end check
# ---------------------------------------------------------------------------

NO_LAUNCHES = {"decode_attention": 0, "emit_norm_logits": 0, "attention": 0, "ssd": 0,
               "rmsnorm": 0}

PROMPT_LENS = [17, 600, 128, 255, 64, 383, 511, 31, 129, 450, 200, 97]


def run_engine(cfg, params, label, want, **serve):
    """Serve the 12 requests under ``ServeConfig(**serve)``; the launch
    counters, zeroed just before the run and read just after, must equal
    ``want(decode steps, prefill calls)``.  Returns the out_tokens and
    the launch counts of the run."""
    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.serve.engine import Engine, ServeConfig

    scfg = ServeConfig(max_batch=8, max_len=1024, max_new_tokens=32, **serve)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n) for n in PROMPT_LENS]

    warm = Engine(params, cfg, scfg, device="cuda")  # library handles, first launches
    warm.submit(prompts[0], 2)
    warm.run_until_drained()
    torch.cuda.synchronize()

    eng = Engine(params, cfg, scfg, device="cuda")
    spent = {"_decode": [], "_prefill": []}  # host-clock seconds per call, synchronised

    def timed(name):
        fn = getattr(eng, name)

        def call(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()  # the engine waits for the stream before its draw anyway
            spent[name].append(time.perf_counter() - t)
            return out

        setattr(eng, name, call)

    timed("_decode")
    timed("_prefill")
    K.reset_launches()
    t0 = time.perf_counter()
    reqs = [eng.submit(p) for p in prompts]
    ttft = {}
    for _ in range(10_000):
        eng.step()
        now = time.perf_counter()
        for r in reqs:
            if r.out_tokens and r.uid not in ttft:
                ttft[r.uid] = now - t0
        if not eng.queue and all(r is None for r in eng.active):
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)

    steps = eng.decode_steps
    if not all(r.done and r.status == "ok" for r in reqs):
        fail("not every request finished")
    bad = [t for r in reqs for t in r.out_tokens if not 0 <= t < cfg.vocab_size]
    if bad:
        fail(f"tokens outside [0, {cfg.vocab_size}): {bad[:5]}")
    if any(len(r.out_tokens) != scfg.max_new_tokens for r in reqs):
        fail("a request stopped short of its budget")
    chunks = len(spent["_prefill"])
    expected = want(steps, chunks)
    if launches != expected:
        fail(f"{label}: launch counts {launches}, expected {expected} for {steps} "
             f"decode steps and {chunks} prefill calls")
    tokens = sum(len(r.out_tokens) for r in reqs)
    t = sorted(ttft.values())
    print(f"engine {label} {cfg.name} full width ({cfg.num_layers} layers, d "
          f"{cfg.d_model}, V {cfg.vocab_size}, {cfg.dtype}): {len(reqs)} requests, prompts "
          f"{min(PROMPT_LENS)}-{max(PROMPT_LENS)}, {tokens} tokens, {steps} decode steps in "
          f"{wall:.3f} s: {tokens / wall:.1f} tok/s; TTFT p50 {statistics.median(t) * 1e3:.1f} ms, "
          f"max {t[-1] * 1e3:.1f} ms; launches {launches}", flush=True)
    dec, pre = spent["_decode"], spent["_prefill"]
    print(f"engine {label} time: {len(dec)} decode steps, p50 "
          f"{statistics.median(dec) * 1e3:.2f} ms, total {sum(dec):.3f} s; {chunks} prefill "
          f"calls (chunks of {scfg.prefill_chunk} tokens and tails), p50 "
          f"{statistics.median(pre) * 1e3:.2f} ms, total "
          f"{sum(pre):.3f} s; rest (host bookkeeping, sampling, slot copies) "
          f"{wall - sum(dec) - sum(pre):.3f} s", flush=True)
    return [r.out_tokens for r in reqs], launches


class LayerUpcast:
    """A group-stacked weight read one layer group at a time in fp32: a
    model whose fp32 weights do not fit the card (Moonlight's would take
    115 GB) runs its fp32 steps with one group upcast at a time."""

    def __init__(self, t):
        self.t, self.shape = t, t.shape

    def __getitem__(self, g):
        return self.t[g].float()


def fp32_params(params):
    """``params`` in fp32, the layer groups upcast as they are read."""
    from repro_torch.models.params import map_tree

    return {k: map_tree(LayerUpcast if k == "blocks" else (lambda t: t.float()), v)
            for k, v in params.items()}


def held_to(routes):
    """``moe.replay_routes(routes)``, or nothing when ``routes`` is None."""
    import contextlib

    from repro_torch.models import moe as M

    return contextlib.nullcontext() if routes is None else M.replay_routes(routes)


def check_routes(label, got, want, rows, dtype):
    """Hold the kernel path's routes (``got``, the records of
    ``moe.record_routes``, one a MoE call) to the plain path's
    (``want``), for calls over ``rows`` sequences of equal length.

    Routing is discontinuous: where a token's router logits differ
    between the two paths by delta (their fp32 sums in another order, or
    bf16 values an ulp apart), a pair of logits among its k + 1 largest
    that lie within 2 delta of each other may swap, and from there on the
    token's hidden state (and, through attention, its row's) follows
    another expert.  So at the first layer where a row's routes part,
    every token whose expert ids differ must have such a near-tie in the
    plain path's logits, and its delta must be within the end-to-end
    tolerance of its largest |router logit| (fp32 1e-4, bf16 8 ulps): its
    input was still the plain path's.  A token whose ``keep`` alone
    differs must follow a token of its layer whose ids differ (a rank
    moved).  Returns the rows whose routes parted, the (token, layer)
    decisions that differ, all decisions, and the worst delta/allowed."""
    import torch

    parted = torch.zeros(rows, dtype=torch.bool, device="cuda")
    differ = total = 0
    worst = 0.0
    for layer, (g, w) in enumerate(zip(got, want)):
        t, k = w["expert_ids"].shape
        row = torch.arange(t, device="cuda") // (t // rows)
        ids = (g["expert_ids"] != w["expert_ids"]).any(-1)
        keep = (g["keep"] != w["keep"]).view(t, k).any(-1)
        moved = ids.cumsum(0) > ids.int()  # an earlier token's ids differ
        if bool((keep & ~ids & ~moved).any()):
            fail(f"{label}: layer {layer}: a token's keep differs with no route change before it")
        diff = ids | keep
        differ, total = differ + int(diff.sum()), total + t
        first = ids & ~parted[row]
        if bool(first.any()):
            lg, lw = g["logits"][first], w["logits"][first]
            delta = (lg - lw).abs().amax(-1)
            top = lw.abs().amax(-1)
            allowed = 8 * bf16_ulp(top) if dtype == torch.bfloat16 else 1e-4 * top
            srt = lw.sort(-1, descending=True).values[:, : k + 1]
            margin = (srt[:, :-1] - srt[:, 1:]).amin(-1)
            if bool((margin > 2 * delta).any()):
                fail(f"{label}: layer {layer}: a route differs with no near-tie in the router")
            worst = max(worst, (delta / allowed).max().item())
            if worst > 1:
                fail(f"{label}: layer {layer}: router logits {worst:.3f} x the tolerance apart "
                     f"where a route first differs")
        parted |= torch.zeros_like(parted).index_fill_(0, row[diff], True)
    return parted, differ, total, worst


def run_decode_end_to_end(cfg, params):
    """One decode state of the served model, stepped with the kernels and
    with ``kernels="plain"`` on copies of the same cache, in fp32 (cache
    upcast, params one layer group at a time: :func:`fp32_params`) and in
    bf16 (as served).

    fp32: the emit tolerance, 1e-4 of each row's largest |logit|.
    bf16: every layer's attention output is rounded to bf16 from fp32
    values that differ in their last bits between the kernel and the
    plain version, and the residual stream carries those one-ulp
    differences through 16 layers: allowed 8 bf16 ulps of each row's
    largest |logit|.  A MoE model (48 layers, whose experts' sums carry
    more) takes the prefill check's bf16 rule instead: with D the
    distance, per row, between the plain step's bf16 and fp32 logits,
    allowed 2 D.  In both, greedy tokens must agree wherever the plain
    top-1 beats its top-2 by more than twice the tolerance.  A MoE model
    runs every step but the fp32 plain one with that step's routes
    imposed (``moe.replay_routes``), so that the logits measure numerics;
    the kernel steps, routing for themselves, are held to the plain
    steps' routes of their dtype by :func:`check_routes`."""
    import numpy as np
    import torch

    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Engine, ServeConfig

    eng = Engine(params, cfg, ServeConfig(max_batch=8, max_len=1024, prefill_chunk=128,
                                          max_new_tokens=500), device="cuda")
    rng = np.random.default_rng(1)
    for n in PROMPT_LENS[:8]:
        eng.submit(rng.integers(1, cfg.vocab_size, size=n))
    for _ in range(3):
        eng.step()
    tokens = torch.tensor([r.out_tokens[-1] for r in eng.active], device="cuda")
    lengths = torch.tensor(eng.lengths, device="cuda")
    base = eng.cache
    del eng

    logits, free, ref = {}, {}, None
    for dtype in (torch.float32, torch.bfloat16):
        p = fp32_params(params) if dtype == torch.float32 else params
        c_cfg = cfg.with_overrides(dtype=dtype)

        def step(mode, replay):
            cache = {n: {k: t.to(dtype, copy=True) for k, t in blk.items()}
                     for n, blk in base.items()}
            with M.record_routes() as routes, held_to(replay):
                lg, _ = T.decode_step(p, cache, c_cfg, tokens=tokens, lengths=lengths,
                                      kernels=mode)
            return lg, routes

        for mode in ("plain", "cuda"):
            if ref is None:  # fp32 plain: the routes every other step is held to
                logits[mode, dtype], ref = step(mode, None)
                free[mode, dtype] = ref
                continue
            logits[mode, dtype] = step(mode, ref)[0]
            if ref:  # a MoE model: the same step routing for itself
                free[mode, dtype] = step(mode, None)[1]
        torch.cuda.synchronize()
        del p
    for dtype in (torch.float32, torch.bfloat16):
        got, want = logits["cuda", dtype], logits["plain", dtype]
        label = f"end-to-end decode_step kernels vs plain, {dtype}"
        note = ""
        if ref:
            parted, differ, total, worst = check_routes(
                label, free["cuda", dtype], free["plain", dtype], 8, dtype)
            note = (f"; routes held to the fp32 plain step's ({len(ref)} MoE layers); routing "
                    f"for itself the kernel step's routes equal the plain step's in "
                    f"{total - differ}/{total} (token, layer) decisions, rows parted at a "
                    f"near-tie {parted.nonzero().flatten().tolist()}, worst router-logit "
                    f"distance at a first difference {worst:.3f} of the tolerance")
        top = want.abs().amax(dim=-1, keepdim=True)
        if dtype == torch.float32:
            tol = 1e-4 * top
        elif ref:
            drift = (want - logits["plain", torch.float32]).abs().amax(dim=-1, keepdim=True)
            tol = 2 * drift
            note += (f"; bf16 kernels vs fp32 plain: "
                     f"{((got - logits['plain', torch.float32]).abs().amax(-1, keepdim=True) / drift).max().item():.3f}"
                     f" x the bf16 plain step's own drift")
        else:
            tol = 8 * bf16_ulp(top)
        err = (got - want).abs()
        worst = (err / tol).max().item()
        top2 = want.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > 2 * tol.squeeze(-1)
        same = got.argmax(-1) == want.argmax(-1)
        print(f"{label} (B=8, lengths {lengths.tolist()}): max_abs_err={err.max().item():.3e} "
              f"worst/allowed={worst:.3f}; greedy tokens equal in {int(same.sum())}/8 rows, "
              f"{int(decided.sum())} rows with a decided top-1{note}", flush=True)
        if worst > 1:
            fail(f"end-to-end {dtype} logits with the kernels disagree with the plain path")
        if not bool(same[decided].all()):
            fail(f"end-to-end {dtype} greedy tokens differ where the plain top-1 is decided")


def run_prefill_end_to_end(cfg, params):
    """One prefill chunk of 128 tokens at ``pos = 128`` (4 prompts whose
    first chunk is already in the cache), run with ``attn_impl="flash"``
    (the kernel) and ``"dense"`` on copies of the same cache, in fp32
    (cache upcast, params one layer group at a time: :func:`fp32_params`)
    and in bf16 (as served).

    fp32: the kernel and the plain path differ in the order of fp32 sums;
    allowed 1e-4 of each row's largest |logit|, and the greedy tokens
    must be equal.  bf16: the kernel rounds P to bf16 for P.V where the
    dense path keeps fp32, and every layer's output is rounded to bf16.
    With D the largest distance, per row, between the bf16 dense logits
    and the fp32 dense logits (what serving in bf16 moves them), two bf16
    paths that each lie within D of the fp32 result lie within 2 D of
    each other: allowed 2 D.  Greedy tokens must agree wherever the dense
    top-1 beats its top-2 by more than twice the allowance.  A MoE model
    runs every path but the fp32 dense one with that path's routes
    imposed (``moe.replay_routes``), so that D and the errors measure
    numerics; the flash paths, routing for themselves, are held to the
    dense paths' routes of their dtype by :func:`check_routes`."""
    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    b, c, pos = 4, 128, 128
    rng = np.random.default_rng(2)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, size=(b, pos + c)), device="cuda")
    base = T.init_cache(cfg, b, 1024, device="cuda")
    T.prefill_step(params, base, cfg, tokens=toks[:, :pos], pos=0)
    logits, free, ref = {}, {}, None
    for dtype in (torch.float32, torch.bfloat16):
        p = fp32_params(params) if dtype == torch.float32 else params
        c_cfg = cfg.with_overrides(dtype=dtype)

        def prefill(impl, replay):
            cache = {n: {k: t.to(dtype, copy=True) for k, t in blk.items()}
                     for n, blk in base.items()}
            K.reset_launches()
            with M.record_routes() as routes, held_to(replay):
                lg, _ = T.prefill_step(p, cache, c_cfg, tokens=toks[:, pos:], pos=pos,
                                       attn_impl=impl)
            torch.cuda.synchronize()
            want = cfg.num_layers if impl == "flash" else 0
            if K.LAUNCHES["attention"] != want:
                fail(f"prefill_step attn_impl={impl} launched the flash kernel "
                     f"{K.LAUNCHES['attention']} times, expected {want}")
            return lg, routes

        for impl in ("dense", "flash"):
            if ref is None:  # fp32 dense: the routes every other path is held to
                logits[impl, dtype], ref = prefill(impl, None)
                free[impl, dtype] = ref
                continue
            logits[impl, dtype] = prefill(impl, ref)[0]
            if ref:  # a MoE model: the same path routing for itself
                free[impl, dtype] = prefill(impl, None)[1]
        del p
    for dtype in (torch.float32, torch.bfloat16):
        got, want = logits["flash", dtype], logits["dense", dtype]
        label = f"end-to-end prefill_step flash vs dense, {dtype}"
        note = ""
        if ref:
            parted, differ, total, worst = check_routes(
                label, free["flash", dtype], free["dense", dtype], b, dtype)
            note = (f"; routes held to the fp32 dense path's; routing for itself the flash "
                    f"path's routes equal the dense path's in {total - differ}/{total} "
                    f"(token, layer) decisions, rows parted at a near-tie "
                    f"{parted.nonzero().flatten().tolist()}, worst router-logit distance at a "
                    f"first difference {worst:.3f} of the tolerance")
        if dtype == torch.float32:
            tol = 1e-4 * want.abs().amax(dim=-1, keepdim=True)
        else:
            drift = (want - logits["dense", torch.float32]).abs().amax(dim=-1, keepdim=True)
            tol = 2 * drift
            own = ((got - logits["dense", torch.float32]).abs().amax(dim=-1, keepdim=True)
                   / drift).max().item()
            print(f"  bf16 flash vs fp32 dense: {own:.3f} x the bf16 dense path's own drift",
                  flush=True)
        err = (got - want).abs()
        worst = (err / tol).max().item()
        top2 = want.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > 2 * tol.squeeze(-1)
        if dtype == torch.float32:
            decided = torch.ones_like(decided)
        same = got.argmax(-1) == want.argmax(-1)
        print(f"{label} (B={b}, chunk {c} at pos {pos}): max_abs_err={err.max().item():.3e} "
              f"worst/allowed={worst:.3f} (allowed per row "
              f"{[round(x, 5) for x in tol.squeeze(-1).tolist()]}); greedy tokens equal in "
              f"{int(same.sum())}/{b} rows, {int(decided.sum())} compared{note}", flush=True)
        if worst > 1:
            fail(f"end-to-end prefill {dtype}: flash logits disagree with the dense path")
        if not bool(same[decided].all()):
            fail(f"end-to-end prefill {dtype}: greedy tokens differ")


def run_ssm_end_to_end(cfg, params):
    """Mamba2-1.3B as served: a full prefill chunk of 256 tokens, a ragged
    tail of 37 and one decode step (B=4), with the kernels
    (``kernels="cuda"``: SSD, RMSNorm, emit) and with ``"plain"``, each
    path on its own cache from empty, in fp32 (params upcast) and in bf16
    (as served).

    fp32: the two paths compute the same function with fp32 sums in other
    orders, and 48 random-weight blocks carry a difference of a few ulps
    at the first block into the logits (the gated norm divides by each
    row's RMS).  D32 measures that for the plain path itself: the
    distance, per row, between the plain logits and those of the kernel
    route run with every kernel swapped for its plain version (the
    registry's plain ``ssd``, ``rmsnorm`` and ``emit_norm_logits``: the
    same function as ``"plain"``, other orders of sums).  Allowed: 2 D32,
    and at least 1e-4 of the row's largest |logit|.  bf16: the kernel path
    rounds at other places (the intra-chunk y is rounded to bf16 before
    the inter-chunk term is added, as the JAX wrapper does; the emit
    kernel rounds the normalised x and each logit); with D the largest
    distance, per row, between the plain bf16 logits and the plain fp32
    ones (what serving in bf16 moves them), two bf16 paths that each lie
    within D of the fp32 result lie within 2 D of each other: allowed 2 D.
    In both, greedy tokens must agree wherever the plain top-1 beats its
    top-2 by more than twice the allowance."""
    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.models import transformer as T
    from repro_torch.models.params import map_tree

    b, layers = 4, cfg.num_layers
    pieces = ((0, 256), (256, 293))
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, size=(b, 294)), device="cuda")
    lengths = torch.full((b,), 293, dtype=torch.int32, device="cuda")
    # each block's pre-norm and gated norm go through the RMSNorm kernel
    counted = {"cuda": (dict(NO_LAUNCHES, ssd=layers, rmsnorm=2 * layers),
                        dict(NO_LAUNCHES, rmsnorm=2 * layers, emit_norm_logits=1))}
    logits = {}

    def serve(p, c_cfg, mode, key):
        """Prefill the pieces and decode once on a fresh cache; record the
        logits of each and check the launches."""
        cache = T.init_cache(c_cfg, b, 1024, device="cuda")
        prefill_want, decode_want = counted.get(key[0], (NO_LAUNCHES, NO_LAUNCHES))
        for lo, hi in pieces:
            K.reset_launches()
            logits[key + (lo,)], _ = T.prefill_step(p, cache, c_cfg, tokens=toks[:, lo:hi],
                                                    pos=lo, kernels=mode)
            torch.cuda.synchronize()
            if K.LAUNCHES != prefill_want:
                fail(f"mamba prefill {key}: launches {K.LAUNCHES}, expected {prefill_want}")
        K.reset_launches()
        logits[key + ("decode",)], _ = T.decode_step(p, cache, c_cfg, tokens=toks[:, 293],
                                                     lengths=lengths, kernels=mode)
        torch.cuda.synchronize()
        if K.LAUNCHES != decode_want:
            fail(f"mamba decode {key}: launches {K.LAUNCHES}, expected {decode_want}")

    for dtype in (torch.float32, torch.bfloat16):
        p = map_tree(lambda t: t.to(torch.float32) if dtype == torch.float32 else t, params)
        c_cfg = cfg.with_overrides(dtype=dtype)
        for mode in ("cuda", "plain"):
            serve(p, c_cfg, mode, (mode, dtype))
        if dtype == torch.float32:  # the kernel route, every kernel's plain version
            saved = dict(K._CUDA_IMPLS)
            K._CUDA_IMPLS.update({op: K._PLAIN_IMPLS[op]
                                  for op in ("ssd", "rmsnorm", "emit_norm_logits")})
            try:
                serve(p, c_cfg, "cuda", ("route", dtype))
            finally:
                K._CUDA_IMPLS.clear()
                K._CUDA_IMPLS.update(saved)
        del p

    for step in (0, 256, "decode"):
        what = {0: "prefill chunk [0, 256)", 256: "ragged tail [256, 293)",
                "decode": "decode step at 293"}[step]
        ref32 = logits["plain", torch.float32, step]
        for dtype in (torch.float32, torch.bfloat16):
            got, want = logits["cuda", dtype, step], logits["plain", dtype, step]
            if dtype == torch.float32:
                drift = row_max(logits["route", dtype, step] - want)
                tol = torch.maximum(2 * drift, 1e-4 * row_max(want))
                note = (f"D32 per row {[f'{x:.2e}' for x in drift.squeeze(-1).tolist()]}, "
                        f"kernels vs the route's plain versions "
                        f"{row_max(got - logits['route', dtype, step]).max().item():.3e}")
            else:
                drift = row_max(want - ref32)
                tol = 2 * drift
                note = (f"bf16 kernels vs fp32 plain: "
                        f"{(row_max(got - ref32) / drift).max().item():.3f} x the bf16 plain "
                        f"path's own drift D")
            err = (got - want).abs()
            worst = (err / tol).max().item()
            top2 = want.topk(2, dim=-1).values
            decided = (top2[:, 0] - top2[:, 1]) > 2 * tol.squeeze(-1)
            if dtype == torch.float32:
                decided = torch.ones_like(decided)
            same = got.argmax(-1) == want.argmax(-1)
            print(f"end-to-end mamba2-1.3b {what} kernels vs plain, {dtype} (B={b}): "
                  f"max_abs_err={err.max().item():.3e} worst/allowed={worst:.3f}; greedy tokens "
                  f"equal in {int(same.sum())}/{b} rows, {int(decided.sum())} compared; {note}",
                  flush=True)
            if not bool(torch.isfinite(got).all()) or worst > 1:
                fail(f"end-to-end mamba {what} {dtype}: kernel logits disagree with the plain path")
            if not bool(same[decided].all()):
                fail(f"end-to-end mamba {what} {dtype}: greedy tokens differ")


# ---------------------------------------------------------------------------
# StreamEngine phase
# ---------------------------------------------------------------------------


def tree_bytes(tree) -> int:
    from repro_torch import pytree as P

    return sum(t.numel() * t.element_size() for t in P.leaves(tree) if t.is_cuda)


def free_card() -> None:
    """Give back the memory of a phase whose weights were dropped: the
    engines' methods wrapped here for timing and counting close over the
    engine, and such cycles hold its weights until the cyclic garbage
    collector runs."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def guard_rounds(eng, label, shard, rounds, peaks, units=None) -> None:
    """Run each of ``eng``'s rounds (its ``collect``) under
    :class:`no_host_sync` and append its host-clock time to ``rounds``
    and its peak memory rise with its allowance to ``peaks``; fail when
    the rise passes the memory allocated before the round plus the
    round's admission payload plus one cell's cache shard (``shard``
    bytes).  With ``units``, append each collect's unit times."""
    import torch

    collect = eng._round

    def round_fn(consts, states, init_items, overlay):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t = time.perf_counter()
        with no_host_sync():
            out = collect(consts, states, init_items, overlay)
        torch.cuda.synchronize()
        rounds.append(time.perf_counter() - t)
        if units is not None:
            units.append(eng.evaluator.unit_times())
        peak = torch.cuda.max_memory_allocated() - before
        allowed = tree_bytes(consts.get("adm", {}).get("cache")) + shard
        peaks.append((peak, allowed))
        if peak > allowed:
            fail(f"stream engine {label}: a round's peak memory rose {peak} bytes, allowed "
                 f"{allowed} (the admission payload and one cell's cache shard)")
        return out

    eng._round = round_fn


def count_prefills(eng, prefills) -> None:
    """Count ``eng``'s prefill calls in ``prefills[0]``."""
    prefill = eng._prefill

    def counted_prefill(*args, **kw):
        prefills[0] += 1
        return prefill(*args, **kw)

    eng._prefill = counted_prefill


def attention_layers(cfg) -> tuple[int, int]:
    """(self-attention layers, cross-attention layers) of ``cfg``."""
    from repro_torch.models import transformer as T

    plans = T.block_plans(cfg)
    groups = cfg.num_layers // len(plans)
    return tuple(groups * sum(p.mixer == kind for p in plans) for kind in ("attn", "cross_attn"))


def run_stream_engine(cfg, params, label, smi, *, stages=None, serve=None, overlap=False,
                      mesh=None, **pipe):
    """Serve the 12 requests through ``StreamEngine`` ("flash",
    ``kernels="cuda"``); every round's ``collect`` under
    :class:`no_host_sync`.  The launch counters, zeroed just before the
    run and read just after, must show decode attention once per decoded
    item and self-attention layer, the emit once per emitted item, flash
    attention once per prefill call and attention layer and once per
    item and cross-attention layer and, for an rmsnorm model, RMSNorm
    twice per item or prefill call and layer; each round's peak memory must stay
    below the memory allocated before it plus the round's admission
    payload plus one cell's cache shard (no round copies the cache).
    With ``overlap`` (a Future run), events around every unit give the
    stages' overlap over the rounds.  ``mesh`` runs the rounds across the
    ranks of its ``pod`` axis.  Returns the out_tokens and the launch
    counts."""
    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.configs.base import DecodePipelineConfig
    from repro_torch.serve.engine import ServeConfig, StreamEngine

    scfg = ServeConfig(max_batch=8, max_len=1024, max_new_tokens=32, prefill_chunk=128,
                       attn_impl="flash", **(serve or {}))
    pcfg = DecodePipelineConfig(kernels="cuda", **pipe)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n) for n in PROMPT_LENS]
    eng = StreamEngine(params, cfg, scfg, pcfg, stages=stages, mesh=mesh, device="cuda")
    shard = tree_bytes(eng.cell_states) // pcfg.num_cells
    rounds, prefills, peaks, units = [], [0], [], []
    eng.evaluator.time_units = overlap
    guard_rounds(eng, label, shard, rounds, peaks, units if overlap else None)
    count_prefills(eng, prefills)
    K.reset_launches()
    t0 = time.perf_counter()
    reqs = [eng.submit(p) for p in prompts]
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    if not all(r.done and r.status == "ok" for r in reqs):
        fail(f"stream engine {label}: not every request finished")
    if any(len(r.out_tokens) != scfg.max_new_tokens for r in reqs):
        fail(f"stream engine {label}: a request stopped short of its budget")
    bad = [t for r in reqs for t in r.out_tokens if not 0 <= t < cfg.vocab_size]
    if bad:
        fail(f"stream engine {label}: tokens outside [0, {cfg.vocab_size}): {bad[:5]}")
    items = eng.rounds * pcfg.round_steps * pcfg.microbatches
    # an rmsnorm model's two block pre-norms a layer, per item and prefill call
    norms = 2 * cfg.num_layers * (items + prefills[0]) if cfg.norm == "rmsnorm" else 0
    own, cross = attention_layers(cfg)
    want = dict(NO_LAUNCHES, decode_attention=items * own, emit_norm_logits=items,
                attention=prefills[0] * (own + cross) + items * cross, rmsnorm=norms)
    if launches != want:
        fail(f"stream engine {label}: launch counts {launches}, expected {want} for {items} "
             f"items and {prefills[0]} prefill calls")
    tokens = sum(len(r.out_tokens) for r in reqs)
    worst = max(p / a for p, a in peaks)
    print(f"stream engine {label} ({smi}): {cfg.name} full width, {tokens} tokens in "
          f"{wall:.3f} s: {tokens / wall:.1f} tok/s; {eng.rounds} rounds of {pcfg.round_steps} "
          f"steps x {pcfg.microbatches} microbatches over {pcfg.num_cells} cells, round p50 "
          f"{statistics.median(rounds) * 1e3:.1f} ms (host clock), total "
          f"{sum(rounds):.3f} s; no host sync in any collect; peak memory rise per round at "
          f"most {worst:.3f} of the allowed (payload + one shard of {shard} bytes); launches "
          f"{launches}", flush=True)
    if overlap:
        print_overlap(units, f"stream engine {label.split(':')[0]}", smi)
    return [r.out_tokens for r in reqs], launches


def run_stream_engine_phase(cfg, params, smi, engine_greedy, engine_hot):
    """Runs a-f: the StreamEngine under the Lazy and the Future evaluator
    against the Engine's tokens and each other.  Returns the summed
    launch counts, b's tokens (which c, d and e equal) and b's launch
    counts."""
    total = dict(NO_LAUNCHES)
    each = {}

    def run(label, **kw):
        tokens, launches = run_stream_engine(cfg, params, label, smi, **kw)
        for k, v in launches.items():
            total[k] += v
        each[label[0]] = launches
        return tokens

    def agree(x, y):
        return sum(a == b for u, v in zip(x, y) for a, b in zip(u, v))

    n = sum(len(x) for x in engine_greedy)
    a = run("a: Lazy, 4 cells, 1 microbatch", num_cells=4, microbatches=1, round_steps=8,
            admit_per_round=4)
    if a != engine_greedy:
        fail(f"stream engine a: tokens differ from the greedy flash Engine's "
             f"({agree(a, engine_greedy)}/{n} agree)")
    print(f"stream engine a: tokens identical to the greedy flash Engine's ({n}/{n})", flush=True)
    pipe = dict(num_cells=8, microbatches=4)
    b = run("b: Lazy, 8 cells, 4 microbatches", **pipe)
    print(f"stream engine b vs the greedy flash Engine: {agree(b, engine_greedy)}/{n} tokens "
          f"agree position by position (B = 2 rows a microbatch against 8)", flush=True)
    for label, kw in (("c: Future, 4 stages, gpipe", dict(schedule="gpipe", overlap=True)),
                      ("d: Future, 4 stages, one_f_one_b", dict(schedule="one_f_one_b")),
                      ("e: Future, 4 stages, interleaved x2",
                       dict(schedule="interleaved", interleave=2))):
        got = run(label, stages=4, **pipe, **kw)
        if got != b:
            fail(f"stream engine {label[0]}: tokens differ from b's ({agree(got, b)}/{n} agree)")
        print(f"stream engine {label[0]}: tokens identical to b's", flush=True)
    hot = [run(f"f{i}: Future, 4 stages, gpipe, temperature 0.9", stages=4, **pipe,
               serve=dict(temperature=0.9, seed=11)) for i in (1, 2)]
    if hot[0] != hot[1]:
        fail("stream engine f: two identical temperature runs gave different tokens")
    print(f"stream engine f: two runs identical; {agree(hot[0], engine_hot)}/{n} tokens equal to "
          f"the Engine's temperature-0.9 tokens (the emit samples on the card, the Engine on "
          f"the host)", flush=True)
    return total, b, each["b"]


# ---------------------------------------------------------------------------
# Supervised phase
# ---------------------------------------------------------------------------

# Device memory the supervisor's own work (snapshot, numerics scan,
# restore) may add: the scan's few flags, never a cache-sized buffer.
SUPERVISOR_PEAK_BYTES = 1 << 20
# (kind, round) of the chaos scenarios: the Engine's and StreamEngine c's
ENGINE_CHAOS = (("raise", 2), ("nan", 3))
STREAM_CHAOS = (("raise", 2), ("nan", 3), ("wedge", 1), ("sigterm", 4))
MID_ROUND = (2, 5)  # (round, item): the cell that raises once
SLOW_CYCLES = 10_000_000  # torch.cuda._sleep before every cell of that round (~5 ms)


def instrument_supervisor(sup, spent) -> None:
    """Time the supervisor's snapshot, numerics scan, restore and whole
    round on the host clock (each ends in a sync) into ``spent[name]``,
    and fail when the snapshot, scan or restore raises the device's peak
    memory by more than :data:`SUPERVISOR_PEAK_BYTES`: the snapshot lives
    in host memory."""
    import torch

    for name in ("_snapshot", "_check_numerics", "restore", "step"):
        fn = getattr(sup, name)

        def call(*args, _fn=fn, _name=name, **kw):
            torch.cuda.synchronize()
            if _name != "step":
                torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            t = time.perf_counter()
            out = _fn(*args, **kw)
            torch.cuda.synchronize()
            spent.setdefault(_name, []).append(time.perf_counter() - t)
            if _name != "step":
                rise = torch.cuda.max_memory_allocated() - before
                spent.setdefault("rise", []).append(rise)
                if rise > SUPERVISOR_PEAK_BYTES:
                    fail(f"supervisor {_name} raised the device's peak memory by {rise} bytes")
            return out

        setattr(sup, name, call)


def supervised_run(eng, prompts, label, *, fault=None, cfg=None, spent=None, wrap=None):
    """Serve ``prompts`` through ``ServeSupervisor(eng)`` from the
    pristine snapshot ``eng.pristine``, with the chaos ``fault`` (kind,
    round) if given; ``spent`` collects the supervisor's times
    (:func:`instrument_supervisor`), ``wrap(sup)`` may wrap its methods.
    Fails unless every request finishes with 0 lost (and, for sigterm,
    the supervisor drained).  Returns the supervisor, the tokens and the
    launch counts of the run."""
    import signal

    import torch

    from repro_torch import kernels as K
    from repro_torch.serve.supervisor import ServeSupervisor, SupervisorConfig, chaos_injector

    kw = {}
    if fault and fault[0] == "wedge":
        kw["wedge_seconds"] = 2 * cfg.deadline_s
    sup = ServeSupervisor(eng, cfg or SupervisorConfig(),
                          fail_injector=fault and chaos_injector(*fault, **kw))
    sup.restore(eng.pristine)
    if spent is not None:
        instrument_supervisor(sup, spent)
    if wrap is not None:
        wrap(sup)
    prev = signal.getsignal(signal.SIGTERM)
    sup.install_signal_handlers()
    K.reset_launches()
    try:
        reqs = [sup.submit(p) for p in prompts]
        sup.run_until_drained()
    finally:
        signal.signal(signal.SIGTERM, prev)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    if sup.stats["requests_lost"] or not all(r.done and r.status == "ok" for r in reqs):
        fail(f"supervised {label}: requests lost ({sup.stats})")
    if fault and fault[0] == "sigterm" and not (sup.draining
                                                and {"event": "drained"} in sup.events):
        fail(f"supervised {label}: SIGTERM did not drain ({sup.events})")
    if fault and fault[0] != "sigterm" and sup.stats["restarts"] < 1:
        fail(f"supervised {label}: the fault was not detected ({sup.stats})")
    return sup, [r.out_tokens for r in reqs], launches


def print_supervisor_times(label, spent, nbytes, smi) -> dict:
    """The supervisor's costs per round, from :func:`instrument_supervisor`
    (the first snapshot also allocates the supervisor's pinned buffers,
    so it is reported apart).  Returns the snapshot's bytes, p50 (ms) and
    share of the supervised rounds' time."""
    snap, scan, step = spent["_snapshot"], spent["_check_numerics"], spent["step"]
    rest = snap[1:] or snap
    print(f"supervised {label} ({smi}): {len(step)} rounds, round p50 "
          f"{statistics.median(step) * 1e3:.2f} ms (host clock, supervised); snapshot of "
          f"{nbytes} bytes to pinned host memory: first {snap[0] * 1e3:.2f} ms (allocating), "
          f"then p50 {statistics.median(rest) * 1e3:.2f} ms, max {max(rest) * 1e3:.2f} ms "
          f"({nbytes / statistics.median(rest) / 1e9:.1f} GB/s), "
          f"{sum(snap) / sum(step):.3f} of the supervised rounds' time; numerics scan p50 "
          f"{statistics.median(scan) * 1e3:.3f} ms, max {max(scan) * 1e3:.3f} ms; the snapshots "
          f"and scans raised the device's peak memory by at most {max(spent['rise'])} bytes "
          f"(allowed {SUPERVISOR_PEAK_BYTES})", flush=True)
    return {"bytes": nbytes, "p50_ms": statistics.median(rest) * 1e3,
            "share": sum(snap) / sum(step)}


def restore_times(spent) -> str:
    """The restores of a faulty run (host clock, each ending in a sync)."""
    times = spent.get("restore", [])
    return (f"{len(times)} restore(s) of the snapshot into the cache in place, "
            f"{', '.join(f'{t * 1e3:.2f}' for t in times)} ms" if times else "no restore")


def run_supervised_engine(cfg, params, smi, want) -> dict:
    """The ``Engine`` (OLMo-1B ``"flash"``, the kernels) under the
    supervisor: fault-free with its per-round costs, then each fault of
    :data:`ENGINE_CHAOS`; every run's tokens equal ``want`` (the
    unsupervised greedy run's) and its launches equal the decode steps
    and prefill calls it issued, replays included.  Returns the summed
    launch counts."""
    import numpy as np

    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.supervisor import ServeSupervisor

    scfg = ServeConfig(max_batch=8, max_len=1024, max_new_tokens=32, prefill_chunk=128,
                       attn_impl="flash")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n) for n in PROMPT_LENS]
    eng = Engine(params, cfg, scfg, device="cuda")
    eng.pristine = ServeSupervisor(eng).snapshot()
    prefills = [0]
    count_prefills(eng, prefills)
    total = dict(NO_LAUNCHES)
    layers = cfg.num_layers
    base = None
    for fault in (None,) + ENGINE_CHAOS:
        label = f"engine {'fault-free' if fault is None else '%s@%d' % fault}"
        steps0, prefills0, spent = eng.decode_steps, prefills[0], {}
        sup, tokens, launches = supervised_run(eng, prompts, label, fault=fault, spent=spent)
        steps, calls = eng.decode_steps - steps0, prefills[0] - prefills0
        expected = dict(NO_LAUNCHES, decode_attention=steps * layers, emit_norm_logits=steps,
                        attention=calls * layers)
        if launches != expected:
            fail(f"supervised {label}: launch counts {launches}, expected {expected}")
        if tokens != want:
            fail(f"supervised {label}: tokens differ from the unsupervised flash Engine's")
        if base is None:
            base = (steps, calls)
            print_supervisor_times("engine fault-free", spent, tree_bytes(eng.cache), smi)
        # a raise comes before the round's work; a poisoned round ran its
        # one decode step before the scan caught it, and replays it
        replays = sup.stats["restarts"] if fault and fault[0] == "nan" else 0
        if steps != base[0] + replays:
            fail(f"supervised {label}: {steps} decode steps, expected {base[0]} + {replays}")
        for k, v in launches.items():
            total[k] += v
        print(f"supervised {label}: 0 requests lost, tokens identical to the unsupervised "
              f"flash Engine's; stats {sup.stats}; {steps} decode steps ({steps - base[0]} "
              f"replayed) and {calls} prefill calls ({calls - base[1]} replayed); "
              f"{restore_times(spent)}; launches {launches}", flush=True)
    del eng
    return total


def run_supervised_stream(cfg, params, smi, want) -> tuple[dict, float, dict]:
    """StreamEngine run c's program (Future, gpipe, 4 stage streams, 8
    cells, 4 microbatches) under the supervisor: fault-free, each fault of
    :data:`STREAM_CHAOS` (the watchdog at 3x the slowest fault-free round,
    the wedge at twice that), and a cell that raises once at item 5 of
    round 2 while every cell of that round is slowed on the card, so that
    earlier items are still in flight on other stage streams (after the
    restore the cache must equal the round's snapshot bitwise).  Each run
    loses no request and gives ``want`` (run c's tokens); its launches
    are 2 decode attentions a cell call (2 layers a cell), 1 emit an
    emitted item and 16 flash attentions a prefill call, counted from the
    calls it made, replays included.  Returns the summed launch counts,
    the watchdog deadline and the fault-free snapshot reading."""
    import numpy as np
    import torch

    from repro_torch import pytree as P
    from repro_torch.configs.base import DecodePipelineConfig
    from repro_torch.core import graph as G
    from repro_torch.serve.engine import ServeConfig, StreamEngine
    from repro_torch.serve.supervisor import ServeSupervisor, SupervisorConfig

    scfg = ServeConfig(max_batch=8, max_len=1024, max_new_tokens=32, prefill_chunk=128,
                       attn_impl="flash")
    pcfg = DecodePipelineConfig(kernels="cuda", num_cells=8, microbatches=4, schedule="gpipe")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n) for n in PROMPT_LENS]
    eng = StreamEngine(params, cfg, scfg, pcfg, stages=4, device="cuda")
    eng.pristine = ServeSupervisor(eng).snapshot()
    shard = tree_bytes(eng.cell_states) // pcfg.num_cells
    per_cell = cfg.num_layers // pcfg.num_cells
    items = pcfg.round_steps * pcfg.microbatches
    rounds, peaks, prefills = [], [], [0]
    guard_rounds(eng, "supervised c", shard, rounds, peaks)
    count_prefills(eng, prefills)
    calls = {"cell": 0, "emit": 0, "round": 0, "slow": False, "raise_at": None}
    cell_fn, emit, collect = eng._cell_fn, eng._emit, eng._round

    def cell(const, state, item):
        if calls["slow"]:
            torch.cuda._sleep(SLOW_CYCLES)
        if calls["raise_at"] == (calls["round"], G.current_item()):
            calls["raise_at"] = None
            raise RuntimeError("a cell fails mid-round")
        out = cell_fn(const, state, item)
        calls["cell"] += 1
        return out

    def counted_emit(item):
        out = emit(item)
        calls["emit"] += 1
        return out

    def counted_round(*args):
        calls["slow"] = calls["raise_at"] is not None and calls["round"] == MID_ROUND[0]
        try:
            return collect(*args)
        finally:
            calls["round"] += 1
            calls["slow"] = False

    eng._cell_fn, eng._emit, eng._round = cell, counted_emit, counted_round

    def run(label, fault=None, cfg_=None, spent=None, wrap=None):
        for k in ("cell", "emit", "round"):
            calls[k] = 0
        p0, r0 = prefills[0], eng.rounds
        sup, tokens, launches = supervised_run(eng, prompts, label, fault=fault, cfg=cfg_,
                                               spent=spent, wrap=wrap)
        expected = dict(NO_LAUNCHES, decode_attention=calls["cell"] * per_cell,
                        emit_norm_logits=calls["emit"],
                        attention=(prefills[0] - p0) * cfg.num_layers)
        if launches != expected:
            fail(f"supervised {label}: launch counts {launches}, expected {expected}")
        if tokens != want:
            fail(f"supervised {label}: tokens differ from StreamEngine run c's")
        return sup, launches, eng.rounds - r0, prefills[0] - p0

    total = dict(NO_LAUNCHES)

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    spent = {}
    sup, launches, base_rounds, base_prefills = run("c fault-free", spent=spent)
    add(launches)
    base_cells = calls["cell"]
    if base_cells != base_rounds * items * pcfg.num_cells:
        fail(f"supervised c: {base_cells} cell calls for {base_rounds} rounds")
    snapshot = print_supervisor_times("stream c fault-free", spent, tree_bytes(eng.cell_states),
                                      smi)
    deadline = 3 * max(spent["step"])
    print(f"supervised c fault-free: tokens identical to run c's; {base_rounds} rounds, "
          f"{base_prefills} prefill calls; launches {launches}; watchdog deadline "
          f"{deadline:.3f} s (3x the slowest supervised round)", flush=True)
    for fault in STREAM_CHAOS:
        label, spent = "c %s@%d" % fault, {}
        sup, launches, n_rounds, n_prefills = run(
            label, fault, SupervisorConfig(deadline_s=deadline), spent=spent)
        add(launches)
        # raise and sigterm add no work; nan and wedge ran their round once
        # before the scan or the watchdog caught it, and ran it again
        replays = sup.stats["restarts"] if fault[0] in ("nan", "wedge") else 0
        if n_rounds != base_rounds + replays or calls["cell"] != (
                base_cells + replays * items * pcfg.num_cells):
            fail(f"supervised {label}: {n_rounds} rounds and {calls['cell']} cell calls, "
                 f"expected {base_rounds} + {replays} replayed rounds")
        print(f"supervised {label}: 0 requests lost, tokens identical to run c's; stats "
              f"{sup.stats}; {n_rounds} rounds ({replays} replayed), {n_prefills} prefill calls "
              f"({n_prefills - base_prefills} replayed); {restore_times(spent)}; launches "
              f"{launches}", flush=True)

    # A cell raises mid-round with earlier items in flight on the stage
    # streams: after the restore the cache must be the round's snapshot.
    checked = []

    def check_restores(sup):
        restore = sup.restore

        def checked_restore(snap):
            restore(snap)
            torch.cuda.synchronize()
            checked.append(all(torch.equal(leaf.cpu(), host) for leaf, host in
                               zip(P.leaves(eng.cell_states), P.leaves(snap.device))))

        sup.restore = checked_restore

    calls["raise_at"], spent = MID_ROUND, {}
    sup, launches, n_rounds, n_prefills = run("c mid-round", spent=spent, wrap=check_restores)
    add(launches)
    partial = calls["cell"] - base_cells
    if checked != [True] or sup.stats["restarts"] != 1 or n_rounds != base_rounds:
        fail(f"supervised c mid-round: restore checks {checked}, stats {sup.stats}, "
             f"{n_rounds} rounds")
    print(f"supervised c mid-round (a cell raises at item {MID_ROUND[1]} of round "
          f"{MID_ROUND[0]}, every cell of that round slowed by torch.cuda._sleep"
          f"({SLOW_CYCLES})): the cache after the restore equals the round's snapshot "
          f"bitwise; 0 requests lost, tokens identical to run c's; stats {sup.stats}; "
          f"{partial} cell calls of the failed round replayed; {restore_times(spent)}; "
          f"launches {launches}",
          flush=True)
    worst = max(p / a for p, a in peaks)
    print(f"supervised c: every round's peak memory rise at most {worst:.3f} of the "
          f"unsupervised allowance (payload + one shard of {shard} bytes)", flush=True)
    eng._cell_fn, eng._emit = cell_fn, emit
    del eng
    return total, deadline, snapshot


def run_supervised_cli(cfg, deadline, smi) -> dict:
    """The port's serve CLI in process at full width: StreamEngine c's
    program with ``--chaos raise@2`` and the watchdog, then without the
    chaos; the same tokens, 0 requests lost, and the same launches (the
    raise comes before its round's work), 16 decode attentions an
    emitted item.  Returns the summed launch counts."""
    import ast
    import contextlib
    import io
    import re

    import torch

    from repro_torch import kernels as K
    from repro_torch.launch import serve

    argv = ["--arch", cfg.name, "--engine", "stream", "--devices", "4", "--cells", "8",
            "--microbatches", "4", "--max-batch", "8", "--max-len", "1024",
            "--prefill-chunk", "128", "--requests", "12", "--max-new", "32",
            "--prompt-len", "100", "--kernels", "cuda",
            "--watchdog-ms", f"{deadline * 1e3:.0f}"]
    runs = []
    for extra in (["--chaos", "raise@2"], []):
        out = io.StringIO()
        K.reset_launches()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            done = serve.main(argv + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = dict(K.LAUNCHES)
        text = out.getvalue()
        stats = ast.literal_eval(re.search(r"supervisor: (\{.*\})", text).group(1))
        tokens = {r.uid: r.out_tokens for r in done}
        if (len(done) != 12 or stats["requests_lost"]
                or not all(len(t) == 32 for t in tokens.values())):
            fail(f"serve CLI {extra}: {len(done)} requests done, stats {stats}")
        if launches["decode_attention"] != cfg.num_layers * launches["emit_norm_logits"]:
            fail(f"serve CLI {extra}: launch counts {launches}")
        runs.append((tokens, launches, stats))
        print(f"serve CLI {' '.join(extra) or 'fault-free'} (in process, {wall:.1f} s with "
              f"its weights): {text.splitlines()[0]}; {text.splitlines()[1]}; stats {stats}; "
              f"launches {launches}", flush=True)
    (chaos, l_chaos, s_chaos), (clean, l_clean, _) = runs
    if chaos != clean or l_chaos != l_clean or s_chaos["restarts"] != 1:
        fail("serve CLI: --chaos raise@2 did not replay to the fault-free tokens and launches")
    print(f"serve CLI ({smi}): --chaos raise@2 gives the fault-free tokens of all 12 requests "
          f"and the same launches", flush=True)
    total = dict(NO_LAUNCHES)
    for _, launches, _ in runs:
        for k, v in launches.items():
            total[k] += v
    return total


def run_supervised_phase(cfg, params, smi, engine_greedy, stream_c) -> tuple[dict, dict]:
    """The supervised engines and the serve CLI; returns the launches and
    StreamEngine c's fault-free snapshot reading (step 14c's yardstick)."""
    total = dict(NO_LAUNCHES)
    engine = run_supervised_engine(cfg, params, smi, engine_greedy)
    stream, deadline, snapshot = run_supervised_stream(cfg, params, smi, stream_c)
    cli = run_supervised_cli(cfg, deadline, smi)
    for part in (engine, stream, cli):
        for k, v in part.items():
            total[k] += v
    return total, snapshot


# ---------------------------------------------------------------------------
# Stream phase
# ---------------------------------------------------------------------------

BIG_FACTOR = 100000000001  # the paper's stream_big
FATEMAN_POWER = 20
FATEMAN_CAPACITY = 1776  # 1771 terms, padded to 4 x-chunks and 222 cells of 8
FATEMAN_FUTURE_CAPACITY = 1792  # 224 cells of 8: 56 on each of 4 stages
SIEVE_FUTURE_LIMIT = 5000  # 669 primes: 20 blocks of 256 through 48 cells of 16 (12 a stage)


def print_overlap(runs, label, smi) -> None:
    """How much of the stages' device time overlapped, from each unit's
    ``(stage, tick, start_ms, end_ms)`` (one list per collect): the summed
    busy time of the stages (each stage's units merged), the time at
    least one stage was busy, and their difference, the time two or more
    were.  A unit's span runs from its start event to its end event on
    its stage's stream: on a card that waits on the host it is the host's
    time to issue the unit."""
    from repro_torch.roofline.trace import busy_us as union

    busy = any_busy = span = 0.0
    units = stages = 0
    for run in runs:
        ids = sorted({u[0] for u in run})
        busy += sum(union([(a, b) for d, _, a, b in run if d == s]) for s in ids)
        any_busy += union([(a, b) for _, _, a, b in run])
        span += max(b for *_, b in run) - min(a for _, _, a, _ in run)
        units, stages = units + len(run), max(stages, len(ids))
    print(f"{label} overlap ({smi}): {units} units on {stages} stage streams over {span:.1f} "
          f"ms in {len(runs)} collect(s); stages busy {busy:.1f} ms in sum, some stage busy "
          f"{any_busy:.1f} ms, two or more at once {busy - any_busy:.1f} ms "
          f"({(busy - any_busy) / busy:.3f} of the stages' busy time)", flush=True)


class no_host_sync:
    """Run the block with ``torch.cuda.set_sync_debug_mode("error")``: an
    op that syncs the host with the card raises."""

    def __enter__(self):
        import torch

        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode(0)
        return False


def timed_on_card(fn):
    """``fn()`` under :class:`no_host_sync`; returns its value and the
    wall time until the card finished it, in s."""
    import torch

    t = time.perf_counter()
    with no_host_sync():
        out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def run_stream_phase(smi: str):
    """The sieve, both Fateman widths (stream and dense) and a deferred
    computation, on the card; each checked against its host oracle.
    Returns the 4-limb Lazy product and its wall time and the Lazy sieve
    at ``SIEVE_FUTURE_LIMIT`` and its wall time (step 14 holds its runs
    across a rank to them)."""
    import numpy as np
    import torch

    from repro_torch.algorithms import polynomial as poly
    from repro_torch.algorithms import sieve
    from repro_torch.configs.paper_stream import CONFIG
    from repro_torch.core import FutureEvaluator, LazyEvaluator, defer

    lazy = LazyEvaluator()
    stream = sieve.sieve_stream(CONFIG.primes_limit, block_size=CONFIG.primes_block,
                                primes_per_cell=CONFIG.primes_per_cell, device="cuda")
    (primes, count), wall = timed_on_card(lambda: sieve.sieve_result(stream.collect(lazy)))
    ref = sieve.reference_primes(CONFIG.primes_limit)
    p = primes.cpu().numpy()
    if len(ref) != 2262 or int(count) != len(ref) or not np.array_equal(p[p > 0], ref):
        fail(f"sieve: {int(count)} primes below {CONFIG.primes_limit}, expected {len(ref)}")
    print(f"stream sieve ({smi}): limit {CONFIG.primes_limit}, blocks of "
          f"{CONFIG.primes_block}, {CONFIG.primes_per_cell} primes a cell: {stream.num_items} "
          f"blocks x {stream.num_cells} cells, {int(count)} primes, equal to Eratosthenes, "
          f"in {wall:.3f} s (Lazy, no host sync)", flush=True)

    # A smaller sieve under the Lazy evaluator and under the Future
    # evaluator on 4 stage streams (48 cells, 12 a stage); a unit's start
    # and end events on its stage stream give the stages' overlap.
    future = FutureEvaluator(4, schedule="gpipe", time_units=True)
    runs = []
    for ev in (lazy, future):
        stream = sieve.sieve_stream(SIEVE_FUTURE_LIMIT, block_size=CONFIG.primes_block,
                                    primes_per_cell=CONFIG.primes_per_cell, device="cuda")
        runs.append(timed_on_card(lambda: sieve.sieve_result(stream.collect(ev))))
    ((sprimes, scount), swall), ((fprimes, fcount), fwall) = runs
    sp, fp = sprimes.cpu().numpy(), fprimes.cpu().numpy()
    sref = sieve.reference_primes(SIEVE_FUTURE_LIMIT)
    if int(scount) != len(sref) or not np.array_equal(sp[sp > 0], sref):
        fail(f"sieve at {SIEVE_FUTURE_LIMIT}: {int(scount)} primes, expected {len(sref)}")
    if not np.array_equal(fp, sp):
        fail(f"sieve under Future: {int(fcount)} primes, not the Lazy run's {int(scount)}")
    print(f"stream sieve Future ({smi}): limit {SIEVE_FUTURE_LIMIT}, 4 stages (gpipe), "
          f"{stream.num_cells} cells: {int(fcount)} primes, equal to Eratosthenes and to the "
          f"Lazy run, in {fwall:.3f} s (Lazy {swall:.3f} s; no host sync)", flush=True)
    print_overlap([future.unit_times()], "stream sieve Future", smi)

    terms = poly.fateman_terms(FATEMAN_POWER)
    t = time.perf_counter()
    exact = poly.reference_product(terms, terms)
    oracle = time.perf_counter() - t
    for label, limbs, factor in (("stream_big", CONFIG.poly_limbs_big, BIG_FACTOR),
                                 ("stream", CONFIG.poly_limbs_small, 1)):
        mod = 1 << (13 * limbs)
        scaled = {k: v * factor * factor for k, v in exact.items()}
        want = {k: v % mod for k, v in scaled.items() if v % mod}
        wraps = max(scaled.values()) >= mod
        x = poly.fateman_poly(FATEMAN_POWER, FATEMAN_CAPACITY, limbs, factor, device="cuda")
        got, wall = timed_on_card(lambda: poly.times(
            x, x, evaluator=lazy, num_x_chunks=CONFIG.poly_x_chunks,
            terms_per_cell=CONFIG.poly_terms_per_cell))
        dense, dense_wall = timed_on_card(lambda: poly.times_dense(x, x))
        for how, res in (("times", got), ("times_dense", dense)):
            if poly.to_dict(res) != want:
                fail(f"fateman {label}: {how} differs from the exact product"
                     f"{' mod 2^%d' % (13 * limbs) if wraps else ''}")
        bitwise = bool(torch.equal(got.keys, dense.keys) and torch.equal(got.coeffs, dense.coeffs))
        print(f"stream fateman {label} ({smi}): (1+x+y+z)^{FATEMAN_POWER} squared, {limbs} limbs, "
              f"factor {factor}: {len(want)} terms equal to the exact product"
              f"{' mod 2^%d' % (13 * limbs) if wraps else ''} (largest coefficient "
              f"2^{max(scaled.values()).bit_length() - 1}); times (Lazy, {CONFIG.poly_x_chunks} "
              f"x-chunks, {x.capacity // CONFIG.poly_terms_per_cell} cells of "
              f"{CONFIG.poly_terms_per_cell} terms) {wall:.3f} s, times_dense {dense_wall:.3f} s, "
              f"the two bitwise equal: {bitwise}; host oracle {oracle:.1f} s", flush=True)
    # 4 limbs under the Future evaluator: 1792 terms of capacity make 224
    # cells of 8, which split over 4 stages.
    x = poly.fateman_poly(FATEMAN_POWER, FATEMAN_FUTURE_CAPACITY, CONFIG.poly_limbs_small,
                          device="cuda")
    fgot, fwall = timed_on_card(lambda: poly.times(
        x, x, evaluator=FutureEvaluator(4, schedule="gpipe"),
        num_x_chunks=CONFIG.poly_x_chunks, terms_per_cell=CONFIG.poly_terms_per_cell))
    if poly.to_dict(fgot) != poly.to_dict(got):
        fail("fateman stream under Future differs from the Lazy product")
    print(f"stream fateman stream Future ({smi}): {CONFIG.poly_limbs_small} limbs, 4 stages "
          f"(gpipe), {x.capacity // CONFIG.poly_terms_per_cell} cells: equal to the exact "
          f"product mod 2^{13 * CONFIG.poly_limbs_small} and to the Lazy run, in {fwall:.3f} s "
          f"(Lazy {wall:.3f} s; no host sync)", flush=True)

    # defer: a side-stream computation, forced while the current stream works
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    a = torch.randn(4096, 4096, device="cuda", generator=gen)
    b = torch.randn(4096, 4096, device="cuda", generator=gen)

    def f(u, v):
        return (torch.sin(u) * v + u.square()).cumsum(dim=1)

    with no_host_sync():
        fut = defer(f, a, b)
        busy = a
        for _ in range(8):  # other work on the current stream meanwhile
            busy = torch.tanh(busy @ b) * 0.5
        value = fut.force()
        after = value[:, -1] + busy[:, 0]  # a consumer after the force
    torch.cuda.synchronize()
    if fut._stream == torch.cuda.current_stream():
        fail("defer ran on the current stream")
    if not torch.equal(value, f(a, b)) or not torch.isfinite(after).all():
        fail("defer: the forced value differs from the direct computation")
    print("stream defer: a side-stream computation forced on the current stream after 8 "
          "matmuls there equals the direct computation bitwise (no host sync)", flush=True)
    return got, wall, sprimes, swall


# ---------------------------------------------------------------------------
# Moonlight phase: Mixture-of-Experts serving at full width and depth
# ---------------------------------------------------------------------------

MOONLIGHT_PARAMS = 28_888_467_456  # the JAX package's model_layout
CARD_BYTES = 80e9  # an H100's device memory, as its data sheet gives it


def run_moe_apply(cfg, params, smi) -> None:
    """Layer 0's MoE block at full width on 8 tokens (a decode step's
    rows) and on 128 (a prefill chunk): 20 calls under
    :class:`no_host_sync` give the same bits as a first call (the combine
    adds each token's k contributions in a fixed order), and one call's
    device time stands beside the least time for its bytes: the dense
    (E, C, d) dispatch reads every expert's weights."""
    import torch

    from repro_torch import pytree as P
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.roofline.analytic import bound_ms

    p = T._group(params["blocks"], 0)["block0"]["moe"]
    wbytes = sum(t.numel() * t.element_size() for t in P.leaves(p))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    e, f, d = cfg.moe.num_experts, cfg.moe.d_ff_expert, cfg.d_model
    fs = f * cfg.moe.num_shared_experts
    for tokens in (8, 128):
        x = torch.randn((1, tokens, d), generator=gen, device="cuda").to(cfg.dtype)
        first, _ = M.moe_apply(p, x, cfg.moe)
        with no_host_sync():
            outs = [M.moe_apply(p, x, cfg.moe)[0] for _ in range(20)]
        torch.cuda.synchronize()
        same = sum(torch.equal(o, first) for o in outs)
        if same != 20 or not bool(torch.isfinite(first).all()):
            fail(f"moe_apply on {tokens} tokens: {same}/20 repeated calls bitwise equal")
        c = M.expert_capacity(tokens, cfg.moe)
        ms = device_ms([lambda: M.moe_apply(p, x, cfg.moe)])
        host = eager_ms(lambda: M.moe_apply(p, x, cfg.moe))
        ops = 2 * 3 * (e * c * d * f + tokens * d * fs)
        bms, by = bound_ms(wbytes + 2 * x.numel() * x.element_size(), ops, cfg.dtype)
        print(f"moe_apply {cfg.name} layer 0 ({smi}): {tokens} tokens, {e} experts top-"
              f"{cfg.moe.top_k}, capacity {c}, {cfg.dtype}: 20 calls bitwise equal, no host "
              f"sync; device {ms:.4f} ms (eager call {host:.4f} ms), bound {bms:.4f} ms ({by}, "
              f"{wbytes} bytes of weights; bound/device {bms / ms:.3f})", flush=True)


def run_step_times(cfg, params, smi) -> None:
    """A decode step at B = 8 (rows at lengths 17-600) and a 128-token
    prefill call at ``pos = 128``, each captured once into a CUDA graph:
    the device time of the step without the host's launch cost (replays
    between CUDA events), beside the step issued eagerly (host clock to
    a synchronise) and the least time for the bytes of weights it reads."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.roofline.analysis import HBM_BW

    rng = torch.Generator(device="cuda")
    rng.manual_seed(5)
    cache = T.init_cache(cfg, 8, 1024, device="cuda")
    tokens = torch.randint(1, cfg.vocab_size, (8,), generator=rng, device="cuda")
    lengths = torch.tensor(PROMPT_LENS[:8], dtype=torch.int32, device="cuda")
    chunk = torch.randint(1, cfg.vocab_size, (1, 128), generator=rng, device="cuda")
    single = T.init_cache(cfg, 1, 1024, device="cuda")
    wbytes = tree_bytes(params)
    for what, fn in (
            ("decode step (B=8)", lambda: T.decode_step(params, cache, cfg, tokens=tokens,
                                                        lengths=lengths)),
            ("prefill call (128 tokens at pos 128)",
             lambda: T.prefill_step(params, single, cfg, tokens=chunk, pos=128,
                                    attn_impl="flash"))):
        dev = device_ms([fn], reps=5)
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t) / 5 * 1e3
        bms = wbytes / HBM_BW * 1e3
        print(f"{cfg.name} {what} ({smi}): device {dev:.2f} ms (one CUDA graph replayed), "
              f"eager {host:.2f} ms (host clock, synchronised); the {wbytes} bytes of weights "
              f"read once {bms:.2f} ms: device/eager {dev / host:.3f}", flush=True)
    del cache, single


def build_on_card(cfg, want_count, smi):
    """``cfg``'s random weights from seed 0 on the card: prints the
    parameter count, the weight bytes and the build's peak memory; fails
    unless the count is the JAX layout's (``want_count``) and the peak
    leaves room for an 8 x 1024 cache."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params, param_count

    layout = T.model_layout(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t = time.perf_counter()
    params = T.Transformer(cfg, init_params(layout, seed=0, device="cuda")).params
    torch.cuda.synchronize()
    build = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    count, nbytes = param_count(layout), tree_bytes(params)
    cache = sum(m.numel() * m.element_size()
                for blk in T.cache_layout(cfg, 8, 1024).values() for m in blk.values())
    print(f"build ({smi}): {cfg.name}, {cfg.num_layers} layers, {count} parameters, "
          f"{nbytes} bytes of weights, peak memory during the build {peak} bytes ({before} "
          f"allocated before it; cache of 8 x 1024 rows: {cache} bytes more), in {build:.1f} s",
          flush=True)
    if count != want_count:
        fail(f"{cfg.name} has {count} parameters, the JAX layout {want_count}")
    if peak + cache > CARD_BYTES:
        fail(f"{cfg.name}'s build peaks at {peak} bytes: no room for its {cache}-byte cache")
    return params


def run_moonlight(smi) -> dict:
    """Full-width, full-depth Moonlight-16B-A3B (48 layers, 64 experts
    top-6 + 2 shared, V 163840; random weights from seed 0): the build's
    peak memory; the 12 requests through the Engine ("flash",
    ``kernels="cuda"``) with exact launch counts; the decode step and
    the prefill chunk against the plain path, routes included;
    ``moe_apply`` repeatable; the StreamEngine under Lazy (4 cells, 1
    microbatch: the Engine's tokens; on the first 8 layers, 8 cells, 4
    microbatches) and Future (the first 8 layers, 4 stages, gpipe, 8
    cells, 4 microbatches: the Lazy run's tokens).
    Returns the launch counts summed over the served runs."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.params import map_tree

    cfg = get_config("moonshot-v1-16b-a3b").with_overrides(kernels="cuda")
    params = build_on_card(cfg, MOONLIGHT_PARAMS, smi)
    layers = cfg.num_layers
    total = dict(NO_LAUNCHES)

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    # per layer: two RMSNorm pre-norms and one attention a call; the emit
    # kernel (final norm and head) once a decode step; prefill's final
    # norm and head are plain
    engine_tokens, launches = run_engine(
        cfg, params, "moonlight attn_impl=flash kernels=cuda", prefill_chunk=128,
        attn_impl="flash",
        want=lambda steps, chunks: dict(
            NO_LAUNCHES, decode_attention=steps * layers, emit_norm_logits=steps,
            attention=chunks * layers, rmsnorm=2 * (steps + chunks) * layers))
    add(launches)
    # 11d. Roofline and trace: 4 eager decode steps of the Engine, profiled
    run_trace_engine(cfg, params, "11d moonlight engine decode", smi, 4, {
        "decode_attention_kernel": (layers, "decode_attention"),
        "emit_untied_tma_kernel": (1, "emit_norm_logits"),
        "rmsnorm_*": (2 * layers, "rmsnorm"), "flash_*": (0, "attention")})
    run_step_times(cfg, params, smi)
    run_decode_end_to_end(cfg, params)
    run_prefill_end_to_end(cfg, params)
    run_moe_apply(cfg, params, smi)

    n = sum(len(x) for x in engine_tokens)
    a, launches = run_stream_engine(cfg, params, "moonlight a: Lazy, 4 cells, 1 microbatch",
                                    smi, num_cells=4, microbatches=1, round_steps=8,
                                    admit_per_round=4)
    add(launches)
    if a != engine_tokens:
        fail("moonlight stream engine a: tokens differ from the Engine's")
    print(f"moonlight stream engine a: tokens identical to the Engine's ({n}/{n})", flush=True)
    # b and c on the first 8 layers, one a cell (views of the weights),
    # which keeps the script near half its time limit beside the
    # training phase: a holds the full depth to the Engine's tokens, and
    # b and c are held to each other
    cut = 8
    front = {**params, "blocks": map_tree(lambda t: t[:cut], params["blocks"])}
    pipe = dict(num_cells=8, microbatches=4)
    b, launches = run_stream_engine(cfg.with_overrides(num_layers=cut), front,
                                    f"moonlight b: Lazy, {cut} layers, 8 cells, 4 microbatches",
                                    smi, **pipe)
    add(launches)
    c, launches = run_stream_engine(cfg.with_overrides(num_layers=cut), front,
                                    f"moonlight c: Future, {cut} layers, 4 stages, gpipe", smi,
                                    stages=4, schedule="gpipe", overlap=True, **pipe)
    add(launches)
    if c != b:
        fail("moonlight stream engine c: tokens differ from the Lazy run b's")
    print("moonlight stream engine c: tokens identical to b's", flush=True)
    del params, front
    free_card()
    return total


# ---------------------------------------------------------------------------
# The zoo's last two input kinds: cross-attention to vision tokens
# (llama-3.2-vision) and embedding inputs (musicgen-medium)
# ---------------------------------------------------------------------------

# the JAX package's model_layout: llama-3.2-vision-90b cut to 20 layers (4
# groups of its 5-layer period, every width published), musicgen-medium whole
VISION_LAYERS = 20
VISION_PARAMS = 19_214_442_500
MUSICGEN_PARAMS = 1_818_379_776


def check_logits(label, got, want, ref32):
    """``got`` (the kernel path's logits) against ``want`` (the plain
    path's).  fp32 (``ref32`` None): allowed 1e-4 of each row's largest
    |logit|, and the greedy tokens must be equal.  bf16: with D the
    distance, per row, between the plain path's bf16 logits and its fp32
    ones (``ref32``: what serving in bf16 moves them), two bf16 paths that
    each lie within D of the fp32 result lie within 2 D of each other:
    allowed 2 D; greedy tokens must agree wherever the plain top-1 beats
    its top-2 by more than twice the allowance.  Returns (worst/allowed,
    rows with equal tokens, rows compared)."""
    import torch

    if ref32 is None:
        tol = 1e-4 * row_max(want)
    else:
        tol = 2 * row_max(want - ref32)
    err = (got - want).abs()
    worst = (err / tol).max().item()
    top2 = want.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * tol.squeeze(-1)
    if ref32 is None:
        decided = torch.ones_like(decided)
    same = got.argmax(-1) == want.argmax(-1)
    if not bool(torch.isfinite(got).all()) or worst > 1:
        fail(f"{label}: the kernel path's logits are {worst:.3f} x the allowed distance from the "
             f"plain path's")
    if not bool(same[decided].all()):
        fail(f"{label}: greedy tokens differ where the plain top-1 is decided")
    return worst, int(same.sum()), int(decided.sum())


def set_gates(params, seed) -> list[float]:
    """Every cross-attention gate set to a seeded value in [0.5, 1.5):
    ``init_params`` gives them zeros, and ``tanh(0)`` would make each
    cross block add exactly 0, whatever its vision input."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    values = []
    for _, blk in sorted(params["blocks"].items()):
        if "xattn_gate" in blk:
            gate = blk["xattn_gate"]["gate"]
            gate.copy_(torch.rand(gate.shape, generator=gen, device="cuda") + 0.5)
            values += gate.flatten().tolist()
    return values


def run_cross_end_to_end(cfg, params):
    """An image prompt through the cut llama-3.2-vision: a 128-token chunk
    at pos 0 with fresh vision embeds (B 8, 1601 x 8192 from a seed), a
    chunk at pos 128 that reads the vision K/V the first one cached, and a
    decode step at 256 from that cache.  The kernel path (``kernels=
    "cuda"``; the chunks under ``attn_impl="flash"``: the flash kernel for
    every self- and cross-attention, the decode step's cross-attention
    through it at Sq = 1; decode attention; RMSNorm; the emit) against the
    plain path (``kernels="plain"``, ``"dense"``), in fp32 (params one
    layer group upcast at a time) and bf16, under :func:`check_logits`.
    The first chunk runs each path on a fresh cache, the vision K/V it
    writes held within the RMSNorm phase's rule (the same einsum on both
    paths); the second chunk and the step run each path on a copy of the
    plain path's cache after the call before, as the other end-to-end
    checks do.  The kernel path's launches are exact."""
    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.models import transformer as T

    b, c = 8, 128
    rng = np.random.default_rng(6)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, size=(b, 2 * c + 1)), device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    vision = torch.randn((b, cfg.vision_tokens, cfg.d_model), generator=gen, device="cuda")
    lengths = torch.full((b,), 2 * c, dtype=torch.int32, device="cuda")
    own, cross = attention_layers(cfg)
    norms = 2 * cfg.num_layers
    launches = {"chunk": dict(NO_LAUNCHES, attention=own + cross, rmsnorm=norms),
                "decode": dict(NO_LAUNCHES, decode_attention=own, attention=cross,
                               rmsnorm=norms, emit_norm_logits=1)}
    name = next(n for n, p in enumerate(T.block_plans(cfg)) if p.mixer == "cross_attn")
    name = f"block{name}"
    steps = (("chunk at 0 with vision embeds", "chunk"), ("chunk at 128", "chunk"),
             ("decode step at 256", "decode"))
    logits = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for dtype in (torch.float32, torch.bfloat16):
        p = fp32_params(params) if dtype == torch.float32 else params
        c_cfg = cfg.with_overrides(dtype=dtype)
        ve = vision.to(dtype)
        caches = {mode: T.init_cache(c_cfg, b, 512, device="cuda") for mode in ("plain", "cuda")}
        for i, (what, kind) in enumerate(steps):
            if i:
                caches["cuda"] = {n: {k: t.clone() for k, t in blk.items()}
                                  for n, blk in caches["plain"].items()}
            for mode in ("plain", "cuda"):
                impl = "flash" if mode == "cuda" else "dense"
                K.reset_launches()
                if kind == "chunk":
                    lg, _ = T.prefill_step(p, caches[mode], c_cfg, tokens=toks[:, i * c:(i + 1) * c],
                                           pos=i * c, vision_embeds=None if i else ve,
                                           attn_impl=impl, kernels=mode)
                else:
                    lg, _ = T.decode_step(p, caches[mode], c_cfg, tokens=toks[:, 2 * c],
                                          lengths=lengths, attn_impl=impl, kernels=mode)
                torch.cuda.synchronize()
                want = launches[kind] if mode == "cuda" else NO_LAUNCHES
                if K.LAUNCHES != want:
                    fail(f"{cfg.name} {what} kernels={mode}: launches {K.LAUNCHES}, expected {want}")
                logits[what, mode, dtype] = lg
            if i == 0:
                atol, rtol = RMS_TOL[str(dtype).removeprefix("torch.")]
                for key in ("k", "v"):
                    got, ref = caches["cuda"][name][key].float(), caches["plain"][name][key].float()
                    err = (got - ref).abs()
                    ok = bool((err <= atol + rtol * ref.abs()).all()) and bool(ref.abs().max() > 0)
                    print(f"end-to-end {cfg.name} vision {key} written by the first chunk ({name}, "
                          f"{tuple(got.shape)}), kernels vs plain, {dtype}: max_abs_err "
                          f"{err.max().item():.3e}, bitwise equal {torch.equal(got, ref)}",
                          flush=True)
                    if not ok:
                        fail(f"{cfg.name}: the vision {key} the kernel path cached differ from the "
                             f"plain path's")
        del p, caches
        torch.cuda.empty_cache()
    print(f"end-to-end {cfg.name}: peak memory {torch.cuda.max_memory_allocated()} bytes with "
          f"the fp32 path's layer groups upcast one at a time", flush=True)
    for what, _ in steps:
        for dtype in (torch.float32, torch.bfloat16):
            ref32 = None if dtype == torch.float32 else logits[what, "plain", torch.float32]
            worst, same, decided = check_logits(
                f"{cfg.name} {what} {dtype}", logits[what, "cuda", dtype],
                logits[what, "plain", dtype], ref32)
            print(f"end-to-end {cfg.name} {what} kernels vs plain, {dtype} (B={b}): worst/allowed "
                  f"{worst:.3f}; greedy tokens equal in {same}/{b} rows, {decided} compared",
                  flush=True)


def run_llama_vision(smi) -> dict:
    """llama-3.2-vision-90b at every published width, cut to 20 layers (4
    groups of its period: 16 self-attention and 4 cross-attention
    layers, 38.4 GB in bf16), random weights from seed 0 and every
    cross-attention gate set nonzero (:func:`set_gates`), after
    Moonlight's weights are freed: the build's peak memory; the 12
    requests through the Engine (``"flash"``, ``kernels="cuda"``; no
    vision embeds, as the JAX engines serve it: the cross blocks read the
    zero vision K/V of a fresh cache), whose counters show decode
    attention once per decode step and self-attention layer, flash
    attention once per prefill call and layer and once per decode step
    and cross-attention layer, RMSNorm twice per call and layer and the
    emit once per decode step; one decode step and prefill call as a CUDA
    graph; :func:`run_cross_end_to_end`; the StreamEngine, each round
    under the sync guard: a, Lazy, 4 cells, 1 microbatch (the Engine's
    tokens); b, Lazy, 4 cells, 4 microbatches; c, b under Future on 4
    stage streams (gpipe: b's tokens).  Returns the launch counts summed
    over the served runs."""
    from repro_torch.configs.registry import get_config

    cfg = get_config("llama-3.2-vision-90b").with_overrides(num_layers=VISION_LAYERS,
                                                            kernels="cuda")
    params = build_on_card(cfg, VISION_PARAMS, smi)
    gates = set_gates(params, 8)
    print(f"{cfg.name}: the {len(gates)} cross-attention gates (zeros from init_params) set to "
          f"seeded values {[round(g, 4) for g in gates]}", flush=True)
    layers = cfg.num_layers
    own, cross = attention_layers(cfg)
    total = dict(NO_LAUNCHES)

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    engine_tokens, launches = run_engine(
        cfg, params, "llama-3.2-vision attn_impl=flash kernels=cuda", prefill_chunk=128,
        attn_impl="flash",
        want=lambda steps, chunks: dict(
            NO_LAUNCHES, decode_attention=steps * own, emit_norm_logits=steps,
            attention=chunks * layers + steps * cross, rmsnorm=2 * (steps + chunks) * layers))
    add(launches)
    run_step_times(cfg, params, smi)
    run_cross_end_to_end(cfg, params)

    n = sum(len(x) for x in engine_tokens)
    a, launches = run_stream_engine(cfg, params, "llama-3.2-vision a: Lazy, 4 cells, 1 microbatch",
                                    smi, num_cells=4, microbatches=1, round_steps=8,
                                    admit_per_round=4)
    add(launches)
    if a != engine_tokens:
        fail("llama-3.2-vision stream engine a: tokens differ from the Engine's")
    print(f"llama-3.2-vision stream engine a: tokens identical to the Engine's ({n}/{n})",
          flush=True)
    pipe = dict(num_cells=4, microbatches=4)
    b, launches = run_stream_engine(cfg, params,
                                    "llama-3.2-vision b: Lazy, 4 cells, 4 microbatches", smi,
                                    **pipe)
    add(launches)
    c, launches = run_stream_engine(cfg, params, "llama-3.2-vision c: Future, 4 stages, gpipe",
                                    smi, stages=4, schedule="gpipe", overlap=True, **pipe)
    add(launches)
    if c != b:
        fail("llama-3.2-vision stream engine c: tokens differ from the Lazy run b's")
    print("llama-3.2-vision stream engine c: tokens identical to b's", flush=True)
    del params
    free_card()
    return total


def run_musicgen(smi) -> dict:
    """musicgen-medium whole (48 layers, d 1536, 24 x 64 MHA, untied V
    2048; random weights from seed 0), which takes frame embeddings (its
    EnCodec frontend is a stub; the engines serve token-input archs
    only, as the JAX package's do): ``forward`` over 2 x 256 frames, a
    chunked ``prefill_step`` of 8 rows x 600 frames (chunks of 128 and
    the 88-frame tail, unpadded) and 32 decode steps, each fed seeded
    frames, with the kernels (``kernels="cuda"``, ``attn_impl="flash"``)
    and with ``kernels="plain"`` (``"dense"``), each path on a cache of
    its own from empty, in fp32 (params upcast) and bf16, under
    :func:`check_logits`.  The kernel path's launches are exact: flash
    attention 48 a forward or prefill call, decode attention 48 and the
    emit 1 a decode step, RMSNorm 96 a call.  Returns the kernel path's
    bf16 launch counts."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.params import map_tree

    cfg = get_config("musicgen-medium").with_overrides(kernels="cuda")
    params = build_on_card(cfg, MUSICGEN_PARAMS, smi)
    layers, b, plen, steps = cfg.num_layers, 8, 600, 32
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    frames = torch.randn((b, plen + steps, cfg.d_model), generator=gen, device="cuda")
    pieces = [(lo, min(lo + 128, plen)) for lo in range(0, plen, 128)]
    calls = ([("forward", None)] + [(f"prefill [{lo}, {hi})", (lo, hi)) for lo, hi in pieces]
             + [(f"decode step {t}", plen + t) for t in range(steps)])
    want = {"forward": dict(NO_LAUNCHES, attention=layers, rmsnorm=2 * layers),
            "prefill": dict(NO_LAUNCHES, attention=layers, rmsnorm=2 * layers),
            "decode": dict(NO_LAUNCHES, decode_attention=layers, rmsnorm=2 * layers,
                           emit_norm_logits=1)}
    total, logits, t0 = dict(NO_LAUNCHES), {}, time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        p = map_tree(lambda t: t.float(), params) if dtype == torch.float32 else params
        c_cfg = cfg.with_overrides(dtype=dtype)
        for mode in ("plain", "cuda"):
            impl = "flash" if mode == "cuda" else "dense"
            cache = T.init_cache(c_cfg, b, 1024, device="cuda")
            for what, at in calls:
                K.reset_launches()
                if at is None:
                    lg = T.forward(p, c_cfg, embeds=frames[:2, :256], attn_impl=impl,
                                   kernels=mode)[0][:, -1]
                elif isinstance(at, tuple):
                    lg, _ = T.prefill_step(p, cache, c_cfg, embeds=frames[:, at[0]:at[1]],
                                           pos=at[0], attn_impl=impl, kernels=mode)
                else:
                    lg, _ = T.decode_step(
                        p, cache, c_cfg, embeds=frames[:, at:at + 1], attn_impl=impl,
                        lengths=torch.full((b,), at, dtype=torch.int32, device="cuda"),
                        kernels=mode)
                torch.cuda.synchronize()
                expected = want[what.split()[0]] if mode == "cuda" else NO_LAUNCHES
                if K.LAUNCHES != expected:
                    fail(f"{cfg.name} {what} kernels={mode} {dtype}: launches {K.LAUNCHES}, "
                         f"expected {expected}")
                if mode == "cuda" and dtype == torch.bfloat16:
                    for k, v in K.LAUNCHES.items():
                        total[k] += v
                logits[what, mode, dtype] = lg
            del cache
        del p
    for kind in ("forward", "prefill", "decode"):
        for dtype in (torch.float32, torch.bfloat16):
            rows = [check_logits(f"{cfg.name} {what} {dtype}", logits[what, "cuda", dtype],
                                 logits[what, "plain", dtype],
                                 None if dtype == torch.float32
                                 else logits[what, "plain", torch.float32])
                    for what, _ in calls if what.startswith(kind)]
            n = sum(logits[what, "plain", dtype].shape[0] for what, _ in calls
                    if what.startswith(kind))
            print(f"end-to-end {cfg.name} {kind} ({len(rows)} calls) kernels vs plain, {dtype}: "
                  f"worst/allowed {max(r[0] for r in rows):.3f}; greedy tokens equal in "
                  f"{sum(r[1] for r in rows)}/{n} rows, {sum(r[2] for r in rows)} compared",
                  flush=True)
    print(f"{cfg.name} ({smi}): {len(calls)} calls a path, 4 paths, in "
          f"{time.perf_counter() - t0:.1f} s; kernel path launches (bf16) {total}", flush=True)
    del params
    free_card()
    return total


# ---------------------------------------------------------------------------
# Training phase: full-width, full-depth OLMo-1B
# ---------------------------------------------------------------------------

OLMO_PARAMS = 1_176_764_416
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 8, 2048, 2, 20
# step 10c's checkpoints, which step 12b restores
TRAIN_CKPT = ROOT / "build" / "train_ckpt_smoke"


def check_no_launches(label) -> None:
    from repro_torch import kernels as K

    if K.LAUNCHES != NO_LAUNCHES:
        fail(f"{label}: training launched kernels {K.LAUNCHES}; it runs the plain ops")


def train_setup(cfg):
    """The trainer's configs and step-keyed batches on the card."""
    import torch

    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.train import AdamWConfig, TrainConfig

    tcfg = TrainConfig(num_microbatches=TRAIN_MICRO, attn_impl="chunked", remat=True)
    ocfg = AdamWConfig(learning_rate=3e-4, warmup_steps=5, total_steps=TRAIN_STEPS)
    source = make_source(DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=0,
                                    vocab_size=cfg.vocab_size))

    def batch_fn(step):
        return {k: torch.from_numpy(v).to("cuda") for k, v in source.batch(step).items()}

    return tcfg, ocfg, batch_fn


def run_train_refusals(cfg, params, tcfg, ocfg, batch) -> None:
    """a. ``kernels="cuda"`` refused by ``make_train_step``, and a forward
    on parameters that require grad with ``kernels="cuda"`` stopped by the
    kernel guard (the flash kernel is the first CUDA op an OLMo block
    reaches)."""
    import dataclasses

    import torch

    from repro_torch import pytree as P
    from repro_torch.models import transformer as T
    from repro_torch.train import make_train_step

    for backward in ("autodiff", "planned"):
        try:
            make_train_step(cfg, dataclasses.replace(tcfg, kernels="cuda",
                                                     pipeline_backward=backward), ocfg)
        except ValueError as e:
            print(f"training refuses kernels='cuda' (pipeline_backward={backward}): {e}",
                  flush=True)
        else:
            fail(f"make_train_step accepted kernels='cuda' with pipeline_backward={backward}")
    leaves, treedef = P.flatten(params)
    rg = P.unflatten(treedef, [t.detach().requires_grad_(True) for t in leaves])
    try:
        with torch.enable_grad():
            T.forward(rg, cfg, tokens=batch["tokens"][:1, :128], attn_impl="flash",
                      kernels="cuda")
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
        print(f"kernel guard: {e}", flush=True)
    else:
        fail("a forward under autograd with kernels='cuda' was not stopped by the kernel guard")


def run_trainer(cfg, params, opt, step_fn, batch_fn, smi):
    """b. 20 AdamW steps; every loss finite, steps 16-20 at least 0.5 nat
    below step 1; zero kernel launches after every step."""
    import math

    import torch

    from repro_torch import kernels as K
    from repro_torch.roofline.analysis import PEAK_FLOPS_BF16

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for step in range(TRAIN_STEPS):
        batch = batch_fn(step)
        K.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        check_no_launches(f"train step {step}")
        losses.append(float(metrics["loss"]))
        print(f"train step {step} ({smi}): loss {losses[-1]:.4f} grad norm "
              f"{float(metrics['grad_norm']):.4f} lr {float(metrics['learning_rate']):.3e} "
              f"{times[-1] * 1e3:.1f} ms", flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail(f"training: a loss is not finite: {losses}")
    tail = statistics.mean(losses[-5:])
    if tail > losses[0] - 0.5:
        fail(f"training: steps 16-20 average {tail:.4f}, not 0.5 nat below step 1's "
             f"{losses[0]:.4f}")
    p50 = statistics.median(times)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    peak = torch.cuda.max_memory_allocated()
    print(f"training {cfg.name} ({smi}): {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens ({TRAIN_MICRO} microbatches, remat, attn chunked, AdamW fp32 moments): "
          f"loss {losses[0]:.4f} -> mean of the last 5 {tail:.4f}; step p50 {p50 * 1e3:.1f} ms "
          f"(host clock, synchronised; min {min(times) * 1e3:.1f}, max {max(times) * 1e3:.1f}); "
          f"{tokens / p50:.0f} tokens/s; peak memory {peak / 1e9:.2f} GB "
          f"({(peak - base) / 1e9:.2f} GB above the weights and state); derived dense-bf16 "
          f"share 6*N*T/(p50 * 989e12) = {6 * OLMO_PARAMS * tokens / (p50 * PEAK_FLOPS_BF16):.4f} "
          f"(attention left out)", flush=True)
    return params, opt


def run_fault_replay(cfg, params, opt, step_fn, batch_fn, smi) -> None:
    """c. ``ResilientLoop`` over 10 steps, a checkpoint every 4 and a fault
    injected at step 6, against a fault-free 10-step run from the same
    start: final parameters and optimizer state bitwise equal, under
    ``torch.use_deterministic_algorithms(True)``.  The checkpoints stay
    in ``TRAIN_CKPT`` for step 12."""
    import shutil

    import torch

    from repro_torch import kernels as K
    from repro_torch import pytree as P
    from repro_torch.resilience import InjectedFault, OneShotInjector
    from repro_torch.train import Checkpointer, FaultConfig, ResilientLoop

    steps = 10
    torch.use_deterministic_algorithms(True)
    try:
        K.reset_launches()
        t = time.perf_counter()
        p_ref, o_ref = params, opt
        for step in range(steps):
            p_ref, o_ref, _ = step_fn(p_ref, o_ref, batch_fn(step))
        torch.cuda.synchronize()
        clean_s = time.perf_counter() - t
        directory = TRAIN_CKPT
        shutil.rmtree(directory, ignore_errors=True)
        ckpt = Checkpointer(str(directory), keep=1)
        saves = []
        save = ckpt.save

        def timed_save(step, state, blocking=False):
            t0 = time.perf_counter()
            save(step, state, blocking)
            saves.append(time.perf_counter() - t0)

        ckpt.save = timed_save
        loop = ResilientLoop(step_fn, ckpt, FaultConfig(checkpoint_every=4, max_restarts=1))

        def fault(_):
            raise InjectedFault("injected at step 6")

        t = time.perf_counter()
        p_got, o_got, reached, history = loop.run(
            params, opt, batch_fn, steps, fail_injector=OneShotInjector(6, fault))
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t
        check_no_launches("fault replay")
        if loop.stats["restarts"] != 1 or reached != steps or len(history) != steps:
            fail(f"fault replay: restarts {loop.stats['restarts']}, reached {reached}, "
                 f"{len(history)} history entries")
        pairs = list(zip(P.leaves((p_got, o_got)), P.leaves((p_ref, o_ref))))
        if not all(torch.equal(a, b) for a, b in pairs):
            bad = sum(not torch.equal(a, b) for a, b in pairs)
            fail(f"fault replay: {bad}/{len(pairs)} leaves of the final params and optimizer "
                 "state differ from the fault-free run's")
        nbytes = tree_bytes((p_got, o_got))
        print(f"fault replay {cfg.name} ({smi}): fault at step 6, restored step 4 in "
              f"{loop.restore_seconds[0]:.2f} s ({nbytes / 1e9:.2f} GB of params and AdamW "
              f"state), {len(saves)} saves taking {sum(saves):.2f} s of the loop's host time "
              f"(device->host copy; the write runs on a host future), loop {loop_s:.1f} s "
              f"against {clean_s:.1f} s fault-free; final params and optimizer state bitwise "
              f"equal to the fault-free run's ({len(pairs)} leaves), deterministic algorithms on",
              flush=True)
        # the directory stays: step 12 restores its last checkpoint, then removes it
    finally:
        torch.use_deterministic_algorithms(False)


def olmo_stage_fn(cfg):
    """A pipeline stage of OLMo: its layer groups in order (chunked
    attention, the plain ops)."""
    import torch

    from repro_torch.models import transformer as T

    plans = T.block_plans(cfg)

    def stage_fn(stage_params, x):
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        per = next(iter(stage_params["block0"]["attn"].values())).shape[0]
        for i in range(per):
            x, _, _ = T._apply_group(T._group(stage_params, i), x, cfg, plans,
                                     positions=positions, attn_impl="chunked",
                                     kernels="plain")
        return x

    return stage_fn


def run_planned_backward(cfg, params, smi) -> None:
    """d. ``pipeline_apply`` over OLMo-1B's 16 layers, 4 microbatches of 2 x
    2048 in bf16 with remat: Lazy, Future on 4 stage streams with
    ``backward="autodiff"`` and with ``"planned"``, under one_f_one_b (4
    stages of 4 layers) and interleaved (8 stages of 2, interleave 2);
    outputs and gradients (stage params and input) bitwise equal across
    the three, each run's peak memory beside ``peak_stash_items``, the
    forward under :class:`no_host_sync`."""
    import dataclasses

    import torch

    from repro_torch import kernels as K
    from repro_torch import pytree as P
    from repro_torch.core.pipeline import (
        PipelineConfig, pipeline_apply, pipeline_evaluator, split_stages,
    )
    from repro_torch.models import layers as L

    gen = torch.Generator(device="cpu")
    gen.manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (8, TRAIN_SEQ), generator=gen).to("cuda")
    x0 = L.embed_lookup(params["embed"]["embedding"], tokens).detach()
    stage_fn = olmo_stage_fn(cfg)
    for schedule, stages, interleave in (("one_f_one_b", 4, 1), ("interleaved", 8, 2)):
        split = split_stages(params["blocks"], cfg.num_layers, stages)
        base = PipelineConfig(num_stages=stages, num_microbatches=4, remat=True,
                              schedule=schedule, interleave=interleave)
        results, notes = {}, []
        for label, backward, devices in (("lazy", "autodiff", None),
                                         ("future/autodiff", "autodiff", 4),
                                         ("future/planned", "planned", 4)):
            pcfg = dataclasses.replace(base, backward=backward)
            ev = (None if devices is None
                  else pipeline_evaluator(pcfg, devices, time_units=True))
            leaves, treedef = P.flatten(split)
            sp = [t.detach().requires_grad_(True) for t in leaves]
            x = x0.clone().requires_grad_(True)
            K.reset_launches()
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            with torch.enable_grad():
                with no_host_sync():
                    out = pipeline_apply(stage_fn, P.unflatten(treedef, sp), x, pcfg,
                                         stages=devices, evaluator=ev)
                loss = out.float().square().mean()
                grads = torch.autograd.grad(loss, sp + [x])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            peak = torch.cuda.max_memory_allocated() - mem0
            check_no_launches(f"pipeline {schedule} {label}")
            results[label] = [out.detach()] + list(grads)
            if not all(torch.isfinite(g).all() for g in results[label]):
                fail(f"pipeline {schedule} {label}: a non-finite output or gradient")
            stash = "-" if devices is None else pcfg.peak_stash_items
            notes.append(f"{label} peak {peak / 1e9:.2f} GB (stash bound {stash} microbatches "
                         f"a stage), {secs:.2f} s")
            if ev is not None:
                print_overlap([ev.unit_times()], f"pipeline {schedule} {label} (F and B units)",
                              smi)
            del out, loss, grads, sp, x
        ref = results["lazy"]
        for label in ("future/autodiff", "future/planned"):
            same = [torch.equal(a, b) for a, b in zip(ref, results[label])]
            if not all(same):
                fail(f"pipeline {schedule}: {label} differs from lazy in "
                     f"{same.count(False)}/{len(same)} of the output and gradients")
        print(f"pipeline {schedule} ({stages} stages of {cfg.num_layers // stages} layers, "
              f"interleave {interleave}, 4 microbatches of 2 x {TRAIN_SEQ}, bf16, remat) "
              f"({smi}): output and {len(ref) - 1} gradients bitwise equal across lazy, "
              f"future/autodiff and future/planned; " + "; ".join(notes), flush=True)
        del results, ref, split


def run_training(smi) -> None:
    """10. Training at full width and depth: OLMo-1B (16 layers, d 2048,
    V 50304 tied; 1,176,764,416 parameters in bf16, random from seed 0):
    a, the refusals of ``kernels="cuda"``; b, the AdamW trainer, 20 steps
    of 8 x 2048 tokens in 2 microbatches with remat and chunked
    attention; c, fault replay under ``ResilientLoop``, bitwise; d, the
    planned backward through ``pipeline_apply``, bitwise against
    autodiff and Lazy.  The launch counters stay at zero throughout:
    training runs the plain ops."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params, param_count
    from repro_torch.train import init_opt_state, make_train_step

    started = time.perf_counter()
    cfg = get_config("olmo-1b")
    layout = T.model_layout(cfg)
    if param_count(layout) != OLMO_PARAMS:
        fail(f"olmo-1b has {param_count(layout)} parameters, expected {OLMO_PARAMS}")
    params = init_params(layout, seed=0, device="cuda")
    tcfg, ocfg, batch_fn = train_setup(cfg)
    run_train_refusals(cfg, params, tcfg, ocfg, batch_fn(0))
    step_fn = make_train_step(cfg, tcfg, ocfg)
    # the initial state lives in run_trainer's frame only, as in a
    # trainer that replaces its state each step (the first params are
    # kept for d)
    p_end, o_end = run_trainer(cfg, params, init_opt_state(params, ocfg), step_fn, batch_fn,
                               smi)
    # 11e. Roofline and trace: one more step of the loop, profiled
    p_end, o_end = run_trace_train_step(step_fn, p_end, o_end, batch_fn(TRAIN_STEPS), smi)
    run_fault_replay(cfg, p_end, o_end, step_fn, batch_fn, smi)
    del p_end, o_end
    free_card()
    run_planned_backward(cfg, params, smi)
    del params
    free_card()
    print(f"training phase ({smi}): {time.perf_counter() - started:.1f} s; the five kernels "
          f"launched 0 times", flush=True)


# ---------------------------------------------------------------------------
# 12. The mesh layer on a one-rank NCCL process group
# ---------------------------------------------------------------------------

ONE_RANK = ("one rank: NCCL refuses two ranks on one GPU, so this card checks each collective "
            "over a group of one rank only; collectives across ranks, the shards rank by rank "
            "and the sharded step on a 2x2 mesh are checked on 4 gloo ranks on the CPU "
            "(tests/test_torch_mesh.py)")


def run_mesh_collectives(mesh, smi) -> None:
    """12a. The collective futures and the collective helpers over each
    axis of the one-rank (data 1, model 1) mesh, on cuda tensors of a
    decoder's activation rows (8 x 2048) in fp32 and bf16: each equal,
    bitwise, to its size-one result (the input itself; the ring's one
    hop computes on it; the compressed mean is the bf16 cast of the
    error-corrected input, over 1).  A forced future orders the caller's
    stream after the collective with no host sync: forced behind 50 ms of
    ``torch.cuda._sleep`` on the current stream, it returns to the host
    before the card has finished."""
    import torch

    from repro_torch.core.future import all_gather_future, psum_scatter_future
    from repro_torch.parallel import collectives as C
    from repro_torch.train.compression import compress_decompress

    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    checked = []
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((8, 2048), generator=gen, device="cuda").to(dtype)
        for axis in ("data", "model"):
            got = {
                "all_gather_future": (all_gather_future(x, axis, mesh=mesh).force(), x),
                "all_gather_future(tiled=False)": (
                    all_gather_future(x, axis, tiled=False, mesh=mesh).force(), x[None]),
                "psum_scatter_future": (psum_scatter_future(x, axis, mesh=mesh).force(), x),
                "ring_all_gather_overlapped": (torch.stack(C.ring_all_gather_overlapped(
                    x, axis, lambda s, slot: s * (slot + 1), mesh=mesh)), x[None]),
                "reduce_scatter_then_all_gather": (
                    C.reduce_scatter_then_all_gather(x, axis, mesh=mesh).force(), x),
            }
            err = 1e-3 * torch.randn((8, 2048), generator=gen, device="cuda")
            red, new_err = C.pod_allreduce_compressed({"g": x.float()}, axis, {"g": err},
                                                      mesh=mesh)
            q, want_err = compress_decompress({"g": x.float()}, {"g": err})
            got["pod_allreduce_compressed"] = (
                red["g"], (q["g"].to(torch.bfloat16) / 1).to(torch.float32))
            got["pod_allreduce_compressed (error)"] = (new_err["g"], want_err["g"])
            for name, (a, b) in got.items():
                if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
                    fail(f"12a {name} over {axis} ({dtype}): not its size-one result")
                checked.append(name)
    x = torch.randn((8, 2048), generator=gen, device="cuda")
    all_gather_future(x, "data", mesh=mesh).force()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # about 50 ms at the H100's 1.98 GHz
    t = time.perf_counter()
    fut = all_gather_future(x, "data", mesh=mesh)
    y = fut.force() * 2
    host_ms = (time.perf_counter() - t) * 1e3
    ended = torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    if ended or host_ms > 25 or not torch.equal(y, x * 2):
        fail(f"12a: a forced all-gather future held the host {host_ms:.2f} ms behind 50 ms of "
             f"device work (card done: {ended})")
    print(f"12a collectives ({smi}): {len(checked)} results of {len(set(checked))} functions "
          f"(fp32 and bf16, over data and model) bitwise equal to their size-one results; a "
          f"forced future returned to the host in {host_ms:.3f} ms with 50 ms of device work "
          f"still queued (no host sync)", flush=True)


def run_elastic_resume(mesh, smi) -> None:
    """12b. Elastic resume at full width: step 10c's last checkpoint of
    OLMo-1B (params and AdamW state) restored into a template sharded by
    ``TRAIN_RULES`` on the mesh of ``choose_elastic_plan(1)``
    (``remesh_state`` of a zero state: every leaf a DTensor with its
    rule's placements); then 2 steps of ``make_train_step(...,
    param_pspecs=...)`` under that mesh against 2 unsharded steps from
    the same restored state (its local tensors: on one rank a shard is
    the whole leaf), on step 10's batches 10 and 11 under deterministic
    algorithms: losses and every leaf bitwise equal."""
    import torch

    from repro_torch import pytree as P
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.params import abstract_params
    from repro_torch.parallel import sharding as SH
    from repro_torch.train import Checkpointer, abstract_opt_state, make_train_step
    from repro_torch.train.elastic import choose_elastic_plan, remesh_state

    cfg = get_config("olmo-1b")
    layout = T.model_layout(cfg)
    tcfg, ocfg, batch_fn = train_setup(cfg)
    plan = choose_elastic_plan(1)
    mesh = make_mesh(plan.mesh_shape[:2], plan.axis_names[:2])
    a_params = abstract_params(layout)
    zeros = P.tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype, device="cuda"),
                       {"params": a_params, "opt_state": abstract_opt_state(a_params, ocfg)})

    def sharded(tree):
        return remesh_state(tree, layout, SH.TRAIN_RULES, mesh)

    template = {"params": sharded(zeros["params"]),
                "opt_state": {"m": sharded(zeros["opt_state"]["m"]),
                              "v": sharded(zeros["opt_state"]["v"]),
                              "step": zeros["opt_state"]["step"]}}
    del zeros
    torch.cuda.synchronize()
    t = time.perf_counter()
    restored, step = Checkpointer(str(TRAIN_CKPT)).restore(template)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    pairs = list(zip(P.leaves(restored), P.leaves(template)))
    del template
    n_dt = sum(SH.is_dtensor(x) for x, _ in pairs)
    if n_dt != len(pairs) - 1 or not all(
            not SH.is_dtensor(x) or (x.device_mesh is mesh and x.placements == y.placements
                                     and x.to_local().shape == x.shape) for x, y in pairs):
        fail("12b: the restored state is not laid out as its sharded template")
    del pairs
    local = P.tree_map(lambda x: x.to_local() if SH.is_dtensor(x) else x, restored)
    pspecs = SH.param_pspecs(layout, SH.TRAIN_RULES, mesh)
    steps = 2
    runs = {}
    starts = {"unsharded": (local["params"], local["opt_state"]),
              "sharded": (restored["params"], restored["opt_state"])}
    del local, restored  # each run holds its own start, until its first step
    torch.use_deterministic_algorithms(True)
    try:
        for label in ("unsharded", "sharded"):
            params, opt_state = starts.pop(label)
            fn = make_train_step(cfg, tcfg, ocfg,
                                 param_pspecs=pspecs if label == "sharded" else None)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses, times = [], []
            for i in range(steps):
                batch = batch_fn(step + i)
                torch.cuda.synchronize()
                t = time.perf_counter()
                if label == "sharded":
                    with SH.set_mesh(mesh):
                        params, opt_state, metrics = fn(params, opt_state, batch)
                else:
                    params, opt_state, metrics = fn(params, opt_state, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
                loss = metrics["loss"]
                losses.append(loss.to_local() if SH.is_dtensor(loss) else loss)
            runs[label] = (losses, times, torch.cuda.max_memory_allocated(),
                           [x.to_local() if SH.is_dtensor(x) else x
                            for x in P.leaves((params, opt_state))])
            del params, opt_state, metrics
    finally:
        torch.use_deterministic_algorithms(False)
    check_no_launches("12b elastic resume")
    (lu, tu, pu, fu), (ls, ts, ps, fs) = runs["unsharded"], runs["sharded"]
    same_loss = all(torch.equal(a, b) for a, b in zip(lu, ls))
    same = [torch.equal(a, b) for a, b in zip(fu, fs)]
    if not same_loss or not all(same):
        worst = max((a.float() - b.float()).abs().max().item() for a, b in zip(fu, fs))
        fail(f"12b: the sharded continuation differs from the unsharded one: losses "
             f"{[float(x) for x in lu]} vs {[float(x) for x in ls]}, "
             f"{same.count(False)}/{len(same)} leaves differ (max |diff| {worst:.3e})")
    print(f"12b elastic resume {cfg.name} ({smi}): checkpoint step {step} restored into "
          f"{n_dt} DTensor leaves on the {plan.mesh_shape[:2]} mesh of choose_elastic_plan(1) "
          f"in {restore_s:.2f} s; {steps} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens: losses {[float(x) for x in ls]} and all {len(same)} leaves bitwise equal "
          f"to the unsharded steps'; step p50 sharded {statistics.median(ts) * 1e3:.1f} ms, "
          f"unsharded {statistics.median(tu) * 1e3:.1f} ms (the median of {steps} steps, the "
          f"first a new step function's first call: sharded "
          f"{[round(x * 1e3, 1) for x in ts]} ms, unsharded {[round(x * 1e3, 1) for x in tu]}; "
          f"deterministic algorithms on; host clock, synchronised); peak "
          f"memory sharded {ps / 1e9:.2f} GB, unsharded {pu / 1e9:.2f} GB", flush=True)
    for n in (512, 256, 128):
        p = choose_elastic_plan(n, preferred_pipeline=2)
        c = p.schedule
        print(f"12b choose_elastic_plan({n}, preferred_pipeline=2): mesh {p.mesh_shape} "
              f"{p.axis_names}, {p.num_microbatches} microbatches, schedule "
              f"{c.schedule} M {c.num_chunks} V {c.interleave} bubble {c.bubble:.4f}",
              flush=True)


def run_dryrun_cells(smi) -> None:
    """12c. The dry run: every ``all_cells()`` cell on both production
    mesh shapes (16 x 16 and 2 x 16 x 16), laid out analytically."""
    from repro_torch.configs.registry import all_cells
    from repro_torch.launch import dryrun as DR

    t = time.perf_counter()
    records = []
    for arch, shape in all_cells():
        for multi_pod in (False, True):
            try:
                records.append(DR.run_cell(arch, shape, multi_pod, save=False, verbose=False))
            except Exception as e:  # noqa: BLE001 -- named, then the script fails
                fail(f"12c dry run {arch} {shape} multi_pod={multi_pod}: {e!r}")
    big = max(records, key=lambda r: r["memory_analysis"]["argument_size_gib"])
    state = max(records, key=lambda r: r["memory_analysis"]["analytic_state_gib"])
    unfit = [r["cell"] for r in records if not r["memory_analysis"]["fits"]]
    print(f"12c dry run: {len(records)} cells ({len(all_cells())} arch x shape, both mesh "
          f"shapes) in {time.perf_counter() - t:.2f} s of host time; largest argument "
          f"{big['memory_analysis']['argument_size_gib']:.3f} GiB per chip ({big['cell']}), "
          f"largest analytic state {state['memory_analysis']['analytic_state_gib']:.3f} GiB "
          f"({state['cell']}); {len(unfit)} cells above one H100's 80 GB. These are analytic "
          f"counts on the reference's 256- and 512-chip mesh shapes, not times or memory "
          f"taken on any chip", flush=True)


def run_mesh_phase(smi, served) -> dict:
    """12. The mesh layer on a one-rank NCCL process group over ``cuda:0``
    and a (data 1, model 1) ``DeviceMesh``: a, the collectives; b, the
    elastic resume of full-width OLMo-1B from step 10c's checkpoint; c,
    the dry run; then step 13 on the same group (no kernel launches in
    12 and 13), and step 14 (``served``: what it is held to).  Returns
    step 14's launch counts."""
    import shutil

    import torch
    import torch.distributed as dist

    from repro_torch import kernels as K
    from repro_torch.launch.mesh import make_mesh

    started = time.perf_counter()
    K.reset_launches()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        if dist.get_backend() != "nccl" or mesh.device_type != "cuda":
            fail(f"12: the mesh runs on {dist.get_backend()}/{mesh.device_type}, not nccl/cuda")
        print(f"12 mesh phase: NCCL process group of 1 rank on {torch.cuda.get_device_name(0)}, "
              f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}; {ONE_RANK}", flush=True)
        run_mesh_collectives(mesh, smi)
        run_elastic_resume(mesh, smi)
        run_dryrun_cells(smi)
        free_card()
        # 13. The pipelined demo step on the same group
        run_pipeline_phase(smi)
        check_no_launches("mesh phase")
        free_card()
        print(f"mesh phase, steps 12 and 13 ({smi}): {time.perf_counter() - started:.1f} s; the "
              f"five kernels launched 0 times", flush=True)
        # 14. StreamEngine and the paper's programs across a one-rank pod axis
        launches = run_serve_ranks_phase(smi, served)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    free_card()
    return launches


# ---------------------------------------------------------------------------
# 13. launch/pipeline_demo: the pipelined train step with its stages on the
# ranks of a pod axis, on step 12's one-rank NCCL group
# ---------------------------------------------------------------------------

PIPE_LAYERS = 4  # qwen3-32b cut from 64 layers, every published width kept
PIPE_PARAMS = 3_506_223_104  # its model_layout at 4 layers
PIPE_BATCH, PIPE_SEQ = 16, 512  # the demo's PIPE_SMALL batch, in 8 microbatches
PIPE_STAGES = 2
PIPE_STEPS = 2
# (label, schedule, interleave, backward) of step 13b's pipelined runs
PIPE_RUNS = (("gpipe", "gpipe", 1, "autodiff"), ("interleaved V2", "interleaved", 2, "autodiff"),
             ("one_f_one_b planned", "one_f_one_b", 1, "planned"))


def run_pipeline_hop(mesh, smi) -> None:
    """13a. ``ring_hop_future`` over the one-rank ``pod`` axis: the hop is
    the value itself and issues no p2p (torch's ``send`` refuses the
    caller's own rank); a forced future behind 50 ms of queued device
    work returns to the host at once (no host sync)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.future import ring_hop_future

    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    x = torch.randn((2, PIPE_SEQ, 5120), generator=gen, device="cuda")
    issued = []
    saved = {name: getattr(dist, name) for name in ("batch_isend_irecv", "isend", "irecv")}
    for name, fn in saved.items():
        setattr(dist, name, lambda *a, _n=name, _f=fn, **k: issued.append(_n) or _f(*a, **k))
    try:
        same = ring_hop_future(x, "pod", mesh=mesh).force() is x
        x * 2  # the multiply's kernel loaded before the timed call
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)  # about 50 ms at the H100's 1.98 GHz
        t = time.perf_counter()
        y = ring_hop_future({"x": x}, "pod", mesh=mesh, tag=1).force()["x"] * 2
        host_ms = (time.perf_counter() - t) * 1e3
        ended = torch.cuda.current_stream().query()
        torch.cuda.synchronize()
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)
    if not same or issued or ended or host_ms > 25 or not torch.equal(y, x * 2):
        fail(f"13a: the size-1 hop (same object {same}, p2p issued {issued}) or its forced "
             f"future ({host_ms:.2f} ms on the host, card done: {ended}) is not the value")
    print(f"13a ring_hop_future over pod (1 rank; {smi}): the value itself, no p2p issued; a "
          f"forced hop future returned to the host in {host_ms:.3f} ms with 50 ms of device "
          f"work still queued (no host sync)", flush=True)


def run_pipeline_steps(mesh, smi) -> None:
    """13b. qwen3-32b at every published width cut to 4 layers, fp32
    (3,506,223,104 parameters, random from seed 0): the demo's train step
    (``make_pipelined_loss``: embedding, ``pipeline_apply`` over ``pod``
    in 2 stages, final norm, untied head, logsumexp loss, SGD at 1e-3) on
    16 x 512 tokens in 8 microbatches, chunked attention, remat, under
    deterministic algorithms: 2 steps of the Lazy evaluator, then 2 steps
    each across the one-rank pod axis under gpipe, interleaved (2 virtual
    stages) and one_f_one_b with the planned backward, every loss and
    every leaf bitwise equal to the Lazy steps'.  Step p50 and peak memory
    of each run; no kernel launches."""
    import torch

    from repro_torch import pytree as P
    from repro_torch.configs.registry import get_config
    from repro_torch.core.pipeline import local_stages
    from repro_torch.launch import pipeline_demo as PD
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params, param_count

    cfg = get_config("qwen3-32b").with_overrides(num_layers=PIPE_LAYERS, dtype=torch.float32,
                                                 kernels="plain")
    layout = T.model_layout(cfg)
    if param_count(layout) != PIPE_PARAMS:
        fail(f"13b: qwen3-32b at {PIPE_LAYERS} layers has {param_count(layout)} parameters, "
             f"not {PIPE_PARAMS}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    toks = torch.randint(0, cfg.vocab_size, (PIPE_BATCH, PIPE_SEQ + 1), generator=gen,
                         device="cuda")
    batch = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}

    def run(step, pcfg=None):
        params = init_params(layout, seed=0, device="cuda")
        params["blocks"] = PD.stage_params(params["blocks"], PIPE_STAGES)
        if pcfg is not None:
            params["blocks"] = local_stages(params["blocks"], pcfg, mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for _ in range(PIPE_STEPS):
            t = time.perf_counter()
            params, loss = step(params, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            losses.append(loss)
        return params, losses, times, torch.cuda.max_memory_allocated()

    def report(label, losses, times, peak, extra=""):
        print(f"13b {label} ({smi}): losses {[float(x) for x in losses]}; step p50 "
              f"{statistics.median(times) * 1e3:.1f} ms ({[round(x * 1e3, 1) for x in times]} "
              f"ms, the first a new step function's first call; host clock, synchronised; "
              f"deterministic algorithms on); peak memory {peak / 1e9:.2f} GB{extra}", flush=True)

    torch.use_deterministic_algorithms(True)
    try:
        tcfg = PD._train_config()
        params, ref_losses, times, peak = run(
            PD.make_pipelined_loss(cfg, mesh, tcfg, PIPE_STAGES, lazy=True))
        ref = [t.cpu() for t in P.leaves(params)]
        del params
        report(f"Lazy {cfg.name} {PIPE_LAYERS} layers", ref_losses, times, peak)
        if not all(torch.isfinite(x) for x in ref_losses):
            fail(f"13b: the Lazy losses are not finite: {[float(x) for x in ref_losses]}")
        for label, schedule, interleave, backward in PIPE_RUNS:
            tcfg = PD._train_config(pipeline_schedule=schedule, pipeline_interleave=interleave,
                                    pipeline_backward=backward)
            params, losses, times, peak = run(
                PD.make_pipelined_loss(cfg, mesh, tcfg, PIPE_STAGES),
                tcfg.pipeline_config(PIPE_STAGES))
            leaves = P.leaves(params)
            same = [torch.equal(a.cpu(), b) for a, b in zip(leaves, ref)]
            del params, leaves
            if len(same) != len(ref) or not all(same) or not all(
                    torch.equal(a, b) for a, b in zip(losses, ref_losses)):
                fail(f"13b {label}: {same.count(False)}/{len(same)} leaves or the losses "
                     f"{[float(x) for x in losses]} differ from the Lazy steps' "
                     f"{[float(x) for x in ref_losses]}")
            report(f"across pod (1 rank) {label}", losses, times, peak,
                   f"; losses and all {len(same)} leaves bitwise equal to the Lazy steps'")
    finally:
        torch.use_deterministic_algorithms(False)
    check_no_launches("13b pipelined steps")


def run_pipeline_record(smi) -> None:
    """13c. ``pipeline_demo.main()``: the record of qwen3-32b x train_4k
    on the 2x16x16 mesh with the stages over pod, analytically."""
    from repro_torch.launch import pipeline_demo as PD

    rec = PD.main()
    if (rec["compile_seconds"] is not None or rec["memory_analysis"]["temp_size_gib"] is not None
            or any(v is not None for v in rec["hlo_analysis"].values())
            or not rec["analytic_flops"] > 0):
        fail(f"13c: the pipeline record's XLA-only fields are not null, or it has no FLOPs: {rec}")
    print(f"13c pipeline_demo record: {rec['cell']}, {rec['mode']}; arguments "
          f"{rec['memory_analysis']['argument_size_gib']:.3f} GiB per chip, "
          f"{rec['analytic_flops']:.4e} FLOPs a step (analytic counts on the reference's "
          f"512-chip mesh shape, not readings taken on any chip)", flush=True)


def run_pipeline_phase(smi) -> None:
    """13. On step 12's one-rank NCCL group, a one-rank ``pod`` mesh: a,
    the hop; b, the pipelined demo step at full width; c, the record.
    One H100 holds one NCCL rank, so no hop crosses ranks here (four gloo
    ranks check that on the CPU, tests/test_torch_pipeline_demo.py)."""
    from repro_torch import kernels as K
    from repro_torch.launch.mesh import make_mesh

    started = time.perf_counter()
    K.reset_launches()
    mesh = make_mesh((1,), ("pod",))
    run_pipeline_hop(mesh, smi)
    run_pipeline_steps(mesh, smi)
    free_card()
    run_pipeline_record(smi)
    print(f"13 pipeline phase ({smi}): {time.perf_counter() - started:.1f} s; the five kernels "
          f"launched 0 times", flush=True)


# ---------------------------------------------------------------------------
# 14. The StreamEngine and the paper's programs across the ranks of a pod
# axis, on step 12's one-rank NCCL group
# ---------------------------------------------------------------------------

def run_serve_ranks_phase(smi, served) -> dict:
    """14. ``FutureEvaluator(mesh=)`` on step 12's one-rank NCCL group, a
    one-rank ``pod`` mesh (one H100 holds one NCCL rank, so no hop
    crosses ranks here: four gloo ranks check that on the CPU,
    tests/test_torch_future_ranks.py, and four cards
    scripts/serve_ranks.py).  a, full-width OLMo-1B (bf16, ``"flash"``,
    ``kernels="cuda"``, random weights from seed 0, built again) serves
    the 12 requests through ``StreamEngine(mesh=)``, every round under the
    sync guard: 4 cells and 1 microbatch of 8 (run a's pipeline), whose
    tokens must equal the greedy flash Engine's; 8 cells and 4
    microbatches of 2 (run b's) under gpipe and under interleaved (2
    virtual stages), whose tokens must equal run b's and whose
    decode-attention, emit and flash launches must equal b's.  c (after
    a), run a's pipeline under ``ServeSupervisor`` with the chaos faults
    (:func:`run_supervised_ranks`).  b, the sieve at limit 5000 (blocks of
    256, 16 primes a cell: 669 primes) and the 4-limb Fateman product
    ((1+x+y+z)^20 squared) across the axis, each equal to step 9's Lazy
    run.  About 75 s.  ``served``: the Engine's and run b's tokens, b's
    launches, step 5b's snapshot reading, step 9's Lazy product and sieve
    and their wall times.
    Returns the launch counts of 14a's and 14c's runs, summed."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    started = time.perf_counter()
    mesh = make_mesh((1,), ("pod",))
    cfg = get_config("olmo-1b")
    params = T.Transformer(cfg, init_params(T.model_layout(cfg), seed=0, device="cuda")).params
    total = dict(NO_LAUNCHES)

    def run(label, want, what, **pipe):
        tokens, launches = run_stream_engine(cfg, params, f"14a {label}", smi, mesh=mesh,
                                             **pipe)
        if tokens != want:
            agree = sum(a == b for x, y in zip(tokens, want) for a, b in zip(x, y))
            fail(f"14a {label}: tokens differ from {what} ({agree}/{sum(map(len, want))} agree)")
        for k, v in launches.items():
            total[k] += v
        return launches

    run("across 1 pod rank, 4 cells, 1 microbatch", served["engine"], "the greedy flash Engine's",
        num_cells=4, microbatches=1, round_steps=8, admit_per_round=4)
    print("14a stream engine across 1 pod rank, 4 cells, 1 microbatch: tokens identical to the "
          "greedy flash Engine's", flush=True)
    for label, kw in (("gpipe", dict(schedule="gpipe")),
                      ("interleaved x2", dict(schedule="interleaved", interleave=2))):
        launches = run(f"across 1 pod rank, 8 cells, 4 microbatches, {label}", served["b"],
                       "run b's", num_cells=8, microbatches=4, **kw)
        counted = ("decode_attention", "emit_norm_logits", "attention")
        if any(launches[k] != served["b_launches"][k] for k in counted):
            fail(f"14a {label}: launches {launches}, run b's {served['b_launches']}")
        print(f"14a stream engine across 1 pod rank, {label}: tokens identical to run b's, "
              f"decode attention, emit and flash launches equal to b's "
              f"({[launches[k] for k in counted]})", flush=True)
    launches = run_supervised_ranks(cfg, params, mesh, smi, served["engine"],
                                    served["snapshot_c"])
    for k, v in launches.items():
        total[k] += v
    del params
    free_card()
    run_rank_programs(mesh, smi, served)
    print(f"14 serve-ranks phase ({smi}): {time.perf_counter() - started:.1f} s; launches "
          f"{total}", flush=True)
    return total


def run_supervised_ranks(cfg, params, mesh, smi, want, one) -> dict:
    """14c. Run a's pipeline (4 cells, 1 microbatch of 8, 8 steps a round)
    through ``StreamEngine(mesh=)`` on the one-rank pod axis, under
    ``ServeSupervisor``, which agrees each round attempt over the axis's
    NCCL group (its all-gathers run on the card): fault-free with its
    per-round costs, then each fault of :data:`STREAM_CHAOS` (the watchdog
    at 3x the slowest fault-free round, the wedge at twice that).  Each
    run loses no request and gives ``want`` (the greedy flash Engine's
    tokens); its launches are 4 decode attentions a cell call (4 layers a
    cell), 1 emit an emitted item and 16 flash attentions a prefill call,
    counted from the calls it made, replays included.  The snapshot's
    bytes, p50 and share of the supervised round are printed beside
    ``one``, step 5b's one-card supervised StreamEngine c's.  Returns the
    summed launch counts."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.configs.base import DecodePipelineConfig
    from repro_torch.serve.engine import ServeConfig, StreamEngine
    from repro_torch.serve.supervisor import ServeSupervisor, SupervisorConfig

    started = time.perf_counter()
    scfg = ServeConfig(max_batch=8, max_len=1024, max_new_tokens=32, prefill_chunk=128,
                       attn_impl="flash")
    pcfg = DecodePipelineConfig(kernels="cuda", num_cells=4, microbatches=1, round_steps=8,
                                admit_per_round=4)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n) for n in PROMPT_LENS]
    eng = StreamEngine(params, cfg, scfg, pcfg, mesh=mesh, device="cuda")
    eng.pristine = ServeSupervisor(eng).snapshot()
    nbytes = tree_bytes(eng.cell_states)
    per_cell = cfg.num_layers // pcfg.num_cells
    items = pcfg.round_steps * pcfg.microbatches
    prefills = [0]
    count_prefills(eng, prefills)
    calls = {"cell": 0, "emit": 0, "agree": 0}
    cell_fn, emit = eng._cell_fn, eng._emit

    def cell(*args):
        out = cell_fn(*args)
        calls["cell"] += 1
        return out

    def counted_emit(item):
        out = emit(item)
        calls["emit"] += 1
        return out

    eng._cell_fn, eng._emit = cell, counted_emit

    def agreed(sup):
        """Count the supervisor's agreements; each must run on the card's
        NCCL group."""
        if sup._group is None or dist.get_backend(sup._group) != "nccl":
            fail("14c: the supervisor of a ranked engine has no NCCL group to agree over")
        agree = sup._agree

        def counted(*args):
            calls["agree"] += 1
            return agree(*args)

        sup._agree = counted

    total = dict(NO_LAUNCHES)

    def run(label, fault=None, cfg_=None, spent=None):
        for k in calls:
            calls[k] = 0
        p0, r0 = prefills[0], eng.rounds
        sup, tokens, launches = supervised_run(eng, prompts, f"14c {label}", fault=fault,
                                               cfg=cfg_, spent=spent, wrap=agreed)
        expected = dict(NO_LAUNCHES, decode_attention=calls["cell"] * per_cell,
                        emit_norm_logits=calls["emit"],
                        attention=(prefills[0] - p0) * cfg.num_layers)
        if launches != expected:
            fail(f"14c {label}: launch counts {launches}, expected {expected}")
        if tokens != want:
            fail(f"14c {label}: tokens differ from the greedy flash Engine's")
        # two agreements an attempt, one when the fault comes before the step
        if calls["agree"] < 2 * sup.stats["rounds"]:
            fail(f"14c {label}: {calls['agree']} agreements for {sup.stats['rounds']} rounds")
        for k, v in launches.items():
            total[k] += v
        return sup, launches, eng.rounds - r0, prefills[0] - p0

    spent = {}
    sup, launches, base_rounds, base_prefills = run("fault-free", spent=spent)
    base_cells = calls["cell"]
    if base_cells != base_rounds * items * pcfg.num_cells:
        fail(f"14c: {base_cells} cell calls for {base_rounds} rounds")
    mine = print_supervisor_times("14c stream across 1 pod rank fault-free", spent, nbytes, smi)
    deadline = 3 * max(spent["step"])
    print(f"14c supervised across 1 pod rank ({smi}): tokens identical to the greedy flash "
          f"Engine's; {base_rounds} rounds, {calls['agree']} agreements over the NCCL group; "
          f"snapshot of {mine['bytes']} bytes, p50 {mine['p50_ms']:.2f} ms, "
          f"{mine['share']:.3f} of the supervised rounds' time, beside step 5b's one-card "
          f"supervised StreamEngine c: {one['bytes']} bytes, p50 {one['p50_ms']:.2f} ms, "
          f"{one['share']:.3f}; launches {launches}; watchdog deadline {deadline:.3f} s (3x the "
          f"slowest supervised round)", flush=True)
    for fault in STREAM_CHAOS:
        label, spent = "%s@%d" % fault, {}
        sup, launches, n_rounds, n_prefills = run(
            label, fault, SupervisorConfig(deadline_s=deadline), spent=spent)
        # raise and sigterm add no work; nan and wedge ran their round once
        # before the scan or the watchdog caught it, and ran it again
        replays = sup.stats["restarts"] if fault[0] in ("nan", "wedge") else 0
        if n_rounds != base_rounds + replays or calls["cell"] != (
                base_cells + replays * items * pcfg.num_cells):
            fail(f"14c {label}: {n_rounds} rounds and {calls['cell']} cell calls, expected "
                 f"{base_rounds} + {replays} replayed rounds")
        print(f"14c supervised across 1 pod rank {label}: 0 requests lost, tokens identical to "
              f"the greedy flash Engine's; stats {sup.stats}; {n_rounds} rounds ({replays} "
              f"replayed), {n_prefills} prefill calls ({n_prefills - base_prefills} replayed), "
              f"{calls['agree']} agreements; {restore_times(spent)}; launches {launches}",
              flush=True)
    eng._cell_fn, eng._emit = cell_fn, emit
    del eng
    print(f"14c ({smi}): {time.perf_counter() - started:.1f} s; launches {total}", flush=True)
    return total


def run_rank_programs(mesh, smi, served) -> None:
    """14b. The sieve at ``SIEVE_FUTURE_LIMIT`` and step 9's 4-limb
    Fateman product across ``mesh``'s ``pod`` axis, each against step 9's
    Lazy run (the sieve's stream built outside the sync guard: the
    candidates' copy to the card syncs)."""
    import numpy as np
    import torch

    from repro_torch.algorithms import polynomial as poly
    from repro_torch.algorithms import sieve
    from repro_torch.configs.paper_stream import CONFIG
    from repro_torch.core import FutureEvaluator

    ranked = FutureEvaluator(mesh=mesh)
    stream = sieve.sieve_stream(SIEVE_FUTURE_LIMIT, block_size=CONFIG.primes_block,
                                primes_per_cell=CONFIG.primes_per_cell, device="cuda")
    (primes, _), wall = timed_on_card(lambda: sieve.sieve_result(stream.collect(ranked), ranked))
    if not np.array_equal(primes.cpu().numpy(), served["primes"].cpu().numpy()):
        fail("14b sieve across 1 pod rank: the primes differ from step 9's Lazy run's")
    print(f"14b sieve ({smi}): limit {SIEVE_FUTURE_LIMIT}, across 1 pod rank {wall:.3f} s, equal "
          f"to step 9's Lazy run ({served['primes_wall']:.3f} s; no host sync)", flush=True)

    x = poly.fateman_poly(FATEMAN_POWER, FATEMAN_CAPACITY, CONFIG.poly_limbs_small,
                          device="cuda")
    got, wall = timed_on_card(lambda: poly.times(
        x, x, evaluator=ranked, num_x_chunks=CONFIG.poly_x_chunks,
        terms_per_cell=CONFIG.poly_terms_per_cell))
    want = served["product"]
    if not (torch.equal(got.keys, want.keys) and torch.equal(got.coeffs, want.coeffs)):
        fail("14b fateman across 1 pod rank: the product differs from step 9's Lazy one")
    print(f"14b fateman stream ({smi}): (1+x+y+z)^{FATEMAN_POWER} squared, "
          f"{CONFIG.poly_limbs_small} limbs, across 1 pod rank {wall:.3f} s, bitwise step 9's "
          f"Lazy product ({served['product_wall']:.3f} s; no host sync)", flush=True)


# ---------------------------------------------------------------------------
# 11. Roofline and trace: the card's attainable rates beside its
# datasheet peaks, and torch.profiler readings (roofline/trace.py) of a
# served step, a StreamEngine round and a train step
# ---------------------------------------------------------------------------

RATE_COPY_BYTES = 4 << 30  # one 4 GiB buffer copied: 2 x 4 GiB moved
RATE_MATMUL_N = 8192       # a bf16 8192^3 torch.matmul: the yardstick of the tensor cores
OVER_PEAK = 1.05           # a measured rate this far above its datasheet peak fails
PREDICTED_SHARE = 0.95     # device busy a step below this share of the prediction fails
STEP11_SECONDS: list[float] = []  # each step-11 reading's wall time, summed at the end


def run_rates(smi) -> None:
    """11a. The rates the card attains: a device-to-device copy of 4 GiB
    (2 x 4 GiB moved) and a bf16 8192^3 ``torch.matmul`` (a yardstick, as
    the library columns are), each beside its datasheet peak.  A bound
    keeps the peak; a reading above 105 % of it fails."""
    import torch

    from repro_torch.roofline.analysis import HBM_BW, PEAK_FLOPS_BF16

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3 / reps

    started = time.perf_counter()
    src = torch.empty(RATE_COPY_BYTES, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    copy_rate = 2 * RATE_COPY_BYTES / timed(lambda: dst.copy_(src), 5)
    del src, dst
    n = RATE_MATMUL_N
    a, b = (torch.randn((n, n), device="cuda", dtype=torch.bfloat16) for _ in range(2))
    mm_rate = 2 * n**3 / timed(lambda: torch.matmul(a, b), 10)
    del a, b
    torch.cuda.empty_cache()
    print(f"11a attainable rates ({smi}): device-to-device copy of 4 GiB {copy_rate / 1e12:.3f} "
          f"TB/s against the datasheet's {HBM_BW / 1e12:.2f} ({copy_rate / HBM_BW:.3f} of it); "
          f"bf16 {n}^3 matmul {mm_rate / 1e12:.1f} TFLOP/s against {PEAK_FLOPS_BF16 / 1e12:.0f} "
          f"({mm_rate / PEAK_FLOPS_BF16:.3f}); bounds keep the datasheet peaks", flush=True)
    if copy_rate > OVER_PEAK * HBM_BW or mm_rate > OVER_PEAK * PEAK_FLOPS_BF16:
        fail("a measured rate beats its datasheet peak by more than 5 %: the timing is wrong")
    STEP11_SECONDS.append(time.perf_counter() - started)


def print_trace(label, records, steps, smi, unprofiled_s) -> dict:
    """The profiled window's idle share, its 10 longest device gaps with
    the host op that held each, and the 10 kernels with the most device
    time; beside them the share derived from the busy time a step and
    ``unprofiled_s``, the host-clock time of a step without the profiler
    (which slows the host).  Returns the busy time and the window, in
    us."""
    from repro_torch.roofline import trace as TR

    window = TR.span_window(records)
    busy = TR.device_busy_us(records, window)
    idle = TR.idle_share(records, window)
    span = window[1] - window[0]
    gaps = TR.longest_gaps(records, 10, window)
    top = TR.kernel_time_by_name(records, 10, window)
    print(f"{label} trace ({smi}): {steps} profiled steps in {span / 1e3:.3f} ms (host clock, "
          f"profiler on), device busy {busy / 1e3:.3f} ms ({busy / steps / 1e3:.4f} ms a step): "
          f"idle share {idle:.4f}; a step without the profiler {unprofiled_s * 1e3:.3f} ms "
          f"(host clock, synchronised): 1 - busy/step {1 - busy / steps / 1e6 / unprofiled_s:.4f}",
          flush=True)
    print(f"  {label} longest gaps: " + "; ".join(
        f"{g / 1e3:.3f} ms in {op}" for g, _, op in gaps), flush=True)
    print(f"  {label} top kernels: " + "; ".join(
        f"{name} {t / 1e3:.3f} ms x{c}" for name, t, c in top), flush=True)
    return dict(busy_us=busy, window_us=span, idle=idle)


def check_trace_launches(label, records, want) -> None:
    """``want``: {stem pattern: (launches a step, the launch counter's
    total over the window)}.  The trace must count exactly that many in
    every profiled step, and as many in all as the counter.  The trace
    must have lost no launch (a launch call without its device record),
    and its device times' lead over their launches, the error of the
    profiler's clock, is printed beside the window's margins."""
    from repro_torch.roofline import trace as TR

    lost, lead = TR.lost_launches(records), TR.clock_lead_us(records)
    clock = (f"the profiler lost {lost} launches; device times lead their launches by up to "
             f"{lead / 1e3:.3f} ms, against margins of {TR.MARGIN_S * 1e3:.0f} ms")
    got = {p: TR.launches(records, p) for p in want}
    for p, (per_step, counted) in want.items():
        if lost or any(c != per_step for c in got[p]) or sum(got[p]) != counted:
            fail(f"{label}: the trace counts {got[p]} launches of {p} a step, expected "
                 f"{per_step} a step and {counted} in all (the launch counters); {clock}")
    print(f"  {label} launches a step from the trace, equal to the launch counters: "
          + ", ".join(f"{p} {per_step}" for p, (per_step, _) in want.items()) + f"; {clock}",
          flush=True)


def run_trace_engine(cfg, params, label, smi, steps, want) -> None:
    """11b/11d. The ``Engine`` ("flash", the cfg's kernels) on the 12
    requests: after the first step (the 8 slots prefilled), up to 8
    steady decode steps timed on the host clock, then ``steps`` profiled.
    ``want`` gives {stem pattern: (launches a step, counter key)}; the
    trace must count them exactly, as the counters do, make no slab-sized
    cache copy (one layer's K slab of the 8 x 1024 cache), and the device
    must be busy at least 0.95 of ``predicted_tick_seconds(mode="cuda")``
    a step at B 8 and the steps' mean valid kv_len."""
    import numpy as np

    from repro_torch import kernels as K
    from repro_torch.roofline import analytic as AN
    from repro_torch.roofline import trace as TR
    from repro_torch.serve.engine import Engine, ServeConfig

    scfg = ServeConfig(max_batch=8, max_len=1024, max_new_tokens=32, prefill_chunk=128,
                       attn_impl="flash")
    eng = Engine(params, cfg, scfg, device="cuda")
    rng = np.random.default_rng(0)
    for n in PROMPT_LENS:
        eng.submit(rng.integers(1, cfg.vocab_size, size=n))
    started = time.perf_counter()
    eng.step()
    waiting = len(eng.queue)
    unprofiled = []
    for _ in range(min(steps, 8)):  # the 8 slots' 31 decode steps hold 1 + 8 + 16
        t = time.perf_counter()
        eng.step()
        unprofiled.append(time.perf_counter() - t)  # ends in the tokens' copy to the host
    kv_len = []

    def step(_):
        kv_len.append(float(np.mean(eng.lengths + 1)))
        eng.step()

    K.reset_launches()
    records = TR.profile_steps(step, steps)
    counted = dict(K.LAUNCHES)
    if (len(eng.queue) != waiting or None in eng.active
            or eng.decode_steps != 1 + len(unprofiled) + steps):
        fail(f"{label}: a profiled step was not a steady decode step")
    check_trace_launches(label, records, {p: (n, counted[key]) for p, (n, key) in want.items()})
    it = AN._itemsize(cfg)
    slab = scfg.max_batch * scfg.max_len * cfg.num_kv_heads * cfg.head_dim * it
    copies = TR.slab_copy_ops(records, slab)
    print(f"  {label} slab-sized copies ({slab} bytes, one layer's K slab): {len(copies)}",
          flush=True)
    if copies:
        fail(f"{label}: the decode steps copied a cache slab: {copies[:5]}")
    reading = print_trace(label, records, steps, smi, statistics.median(unprofiled))
    kv = round(float(np.mean(kv_len)))
    pred = AN.predicted_tick_seconds(cfg, batch=scfg.max_batch, kv_len=kv, mode="cuda")
    busy = reading["busy_us"] / steps / 1e6
    print(f"  {label} device busy a step {busy * 1e3:.4f} ms against predicted_tick_seconds "
          f"(mode cuda, B 8, kv_len {kv}) {pred['total'] * 1e3:.4f} ms (weights "
          f"{pred['weights'] * 1e3:.4f}, attention {pred['attn'] * 1e3:.4f}, emit "
          f"{pred['emit'] * 1e3:.4f}): {busy / pred['total']:.3f} of it", flush=True)
    if busy < PREDICTED_SHARE * pred["total"]:
        fail(f"{label}: the device is busy {busy * 1e3:.4f} ms a step, below "
             f"{PREDICTED_SHARE} of the predicted {pred['total'] * 1e3:.4f} ms: a count is wrong")
    del eng, records
    STEP11_SECONDS.append(time.perf_counter() - started)


def run_trace_stream_round(cfg, params, smi) -> None:
    """11c. StreamEngine run c (Future on 4 stage streams, gpipe, 8 cells,
    4 microbatches, "flash", ``kernels="cuda"``): its second round timed,
    its third profiled, with one marker launch on each stage stream
    inside a span ``stage d`` after it (the spans name the streams).  The emit kernel must run on the final stage's stream
    only (the tick plan's ``emit`` column), decode attention on every
    stage's, each kernel as often as its launch counter says."""
    import numpy as np
    import torch
    from torch.profiler import record_function

    from repro_torch import kernels as K
    from repro_torch.configs.base import DecodePipelineConfig
    from repro_torch.core.future import stage_stream
    from repro_torch.roofline import trace as TR
    from repro_torch.serve.engine import ServeConfig, StreamEngine

    stages = 4
    scfg = ServeConfig(max_batch=8, max_len=1024, max_new_tokens=32, prefill_chunk=128,
                       attn_impl="flash")
    pcfg = DecodePipelineConfig(num_cells=8, microbatches=4, schedule="gpipe", kernels="cuda")
    eng = StreamEngine(params, cfg, scfg, pcfg, stages=stages, device="cuda")
    rng = np.random.default_rng(0)
    for n in PROMPT_LENS:
        eng.submit(rng.integers(1, cfg.vocab_size, size=n))
    started = time.perf_counter()
    eng.step()
    t = time.perf_counter()
    eng.step()  # ends in the emitted items' copy to the host
    unprofiled = time.perf_counter() - t
    device = torch.device("cuda", torch.cuda.current_device())

    def round_(_):
        eng.step()
        for d in range(stages):
            with torch.cuda.stream(stage_stream(device, d)), record_function(f"stage {d}"):
                torch.ones(1, device=device)

    K.reset_launches()
    records = TR.profile_steps(round_, 1, shapes=False)
    counted = dict(K.LAUNCHES)
    items = pcfg.round_steps * pcfg.microbatches
    check_trace_launches("11c stream engine c round", records, {
        "decode_attention_kernel": (items * cfg.num_layers, counted["decode_attention"]),
        "emit_*": (items, counted["emit_norm_logits"])})
    marks = [TR.span_streams(records, f"stage {d}") for d in range(stages)]
    emit = TR.launch_streams(records, "emit_*")
    attn = TR.launch_streams(records, "decode_attention_kernel")
    print(f"  11c stream engine c round: stage streams {marks}; the emit ran on {emit}, "
          f"decode attention on {attn}", flush=True)
    if any(len(m) != 1 for m in marks) or len({m[0] for m in marks}) != stages:
        fail(f"11c: the stage markers ran on {marks}, not one stream a stage")
    if not TR.only_on_streams(records, "emit_*", marks[-1]):
        fail(f"11c: the emit ran on streams {emit}, not on the final stage's {marks[-1]} only")
    if attn != sorted(m[0] for m in marks):
        fail(f"11c: decode attention ran on {attn}, not on the {stages} stage streams")
    print_trace("11c stream engine c round", records, 1, smi, unprofiled)
    del eng, records
    STEP11_SECONDS.append(time.perf_counter() - started)


def run_trace_train_step(step_fn, params, opt, batch, smi):
    """11e. One step of the train loop timed, the next profiled (no
    shapes): its idle share and top kernels; none of the five kernels
    launches.  A trace that lost device records is taken once more; the
    second must be complete.  Returns the new params and optimizer
    state."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.roofline import trace as TR

    started = time.perf_counter()
    state = [params, opt]
    del params, opt

    def step(_):
        state[0], state[1], _m = step_fn(state[0], state[1], batch)

    torch.cuda.synchronize()
    t = time.perf_counter()
    step(0)
    torch.cuda.synchronize()
    unprofiled = time.perf_counter() - t
    K.reset_launches()
    records = TR.profile_steps(step, 1, shapes=False)
    lost = TR.lost_launches(records)
    if lost:
        # a trace with dropped device records counts nothing: the step (its
        # ~38,000 kernels the most of any traced window) is profiled once
        # more, and that trace too must be complete
        print(f"  11e train step: the profiler lost {lost} launch records; one more step "
              f"profiled", flush=True)
        records = TR.profile_steps(step, 1, shapes=False)
    check_trace_launches("11e train step", records, {
        p: (0, K.LAUNCHES[key]) for p, key in (
            ("decode_attention_kernel", "decode_attention"), ("emit_*", "emit_norm_logits"),
            ("flash_*", "attention"), ("ssd_kernel", "ssd"), ("rmsnorm_*", "rmsnorm"))})
    print_trace("11e train step", records, 1, smi, unprofiled)
    del records
    STEP11_SECONDS.append(time.perf_counter() - started)
    return state[0], state[1]


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs on an NVIDIA GPU")
    try:
        from repro_torch import kernels as K
        from repro_torch.configs.registry import get_config
        from repro_torch.models import transformer as T
        from repro_torch.models.params import init_params
    except ImportError as e:
        fail(f"the repro_torch package is not beside this script ({e})")

    # 1. Setup
    started = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, stdin=subprocess.DEVNULL, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}", flush=True)
    t = time.perf_counter()
    logs = K.build()
    print(f"built {sorted(logs) or 'nothing (up to date)'} in {time.perf_counter() - t:.1f} s", flush=True)
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    # 2. Kernel phase
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    results: dict[str, dict] = {}
    run_decode_attention(gen, results)
    run_emit(gen, results)
    run_flash(gen, results)
    run_ssd(gen, results)
    run_rmsnorm(gen, results)
    torch.cuda.empty_cache()

    # 11a. The card's attainable copy and matmul rates beside its datasheet peaks
    run_rates(smi)

    # 3. Engine phase
    cfg = get_config("olmo-1b")
    params = T.Transformer(cfg, init_params(T.model_layout(cfg), seed=0, device="cuda")).params
    layers = cfg.num_layers

    def olmo_want(flash):
        return lambda steps, chunks: dict(
            NO_LAUNCHES, decode_attention=steps * layers, emit_norm_logits=steps,
            attention=chunks * layers if flash else 0)

    dense_tokens, launches = run_engine(cfg, params, "attn_impl=dense", olmo_want(False),
                                        prefill_chunk=128, attn_impl="dense")
    flash_tokens, flash_launches = run_engine(cfg, params, "attn_impl=flash", olmo_want(True),
                                              prefill_chunk=128, attn_impl="flash")
    launches["flash_attention"] = flash_launches["attention"]
    same = sum(a == b for x, y in zip(dense_tokens, flash_tokens) for a, b in zip(x, y))
    total = sum(len(x) for x in dense_tokens)
    print(f"engine flash vs dense: {same}/{total} tokens agree position by position, "
          f"{sum(x == y for x, y in zip(dense_tokens, flash_tokens))}/{len(dense_tokens)} "
          f"requests identical", flush=True)
    # temperature sampling: the key is a function of (seed, uid, ngen),
    # so a second identical run gives the same tokens
    hot = [run_engine(cfg, params, f"attn_impl=flash temperature=0.9 run {i}", olmo_want(True),
                      prefill_chunk=128, attn_impl="flash", temperature=0.9, seed=11)[0]
           for i in (1, 2)]
    if hot[0] != hot[1]:
        fail("temperature 0.9: two identical runs gave different tokens")
    greedy_same = sum(a == b for x, y in zip(flash_tokens, hot[0]) for a, b in zip(x, y))
    print(f"engine temperature 0.9 (seed 11): two runs identical; {greedy_same}/{total} tokens "
          f"equal to the greedy flash run's", flush=True)

    # 4. End-to-end checks
    run_decode_end_to_end(cfg, params)
    run_prefill_end_to_end(cfg, params)

    # 5. The StreamEngine: decode rounds under the Lazy and Future evaluators
    se_launches, stream_c, b_launches = run_stream_engine_phase(cfg, params, smi, flash_tokens,
                                                                hot[0])

    # 5b. Supervised serving: both engines under ServeSupervisor with chaos
    # faults, and the serve CLI
    sup_launches, snapshot_c = run_supervised_phase(cfg, params, smi, flash_tokens, stream_c)
    for name, op in (("decode_attention", "decode_attention"),
                     ("emit_norm_logits", "emit_norm_logits"), ("flash_attention", "attention")):
        launches[name] += se_launches[op] + sup_launches[op]

    # 11b, 11c. Roofline and trace: 16 steady decode steps of the Engine
    # and one round of StreamEngine c, profiled
    run_trace_engine(cfg, params, "11b olmo-1b engine decode", smi, 16, {
        "decode_attention_kernel": (layers, "decode_attention"),
        "emit_tied*": (1, "emit_norm_logits"), "flash_*": (0, "attention")})
    run_trace_stream_round(cfg, params, smi)
    del params
    free_card()

    # 6. Mamba2-1.3B: engine phase and end-to-end check.  prefill_chunk
    # is the config's SSD chunk, so a full prefill chunk is one SSD chunk
    # of the published Q = 256; a ragged tail is prefilled unpadded.
    cfg = get_config("mamba2-1.3b")
    params = T.Transformer(cfg, init_params(T.model_layout(cfg), seed=0, device="cuda")).params
    layers = cfg.num_layers
    _, ssm_launches = run_engine(
        cfg, params, "kernels=auto", prefill_chunk=cfg.ssm.chunk_size,
        want=lambda steps, chunks: dict(NO_LAUNCHES, ssd=chunks * layers,
                                        rmsnorm=2 * (steps + chunks) * layers,
                                        emit_norm_logits=steps))
    launches["ssd"], launches["rmsnorm"] = ssm_launches["ssd"], ssm_launches["rmsnorm"]
    run_ssm_end_to_end(cfg, params)
    del params
    free_card()

    # 7. Moonlight-16B-A3B: Mixture-of-Experts serving at full width and depth
    moon = run_moonlight(smi)
    for name, op in (("decode_attention", "decode_attention"),
                     ("emit_norm_logits", "emit_norm_logits"), ("flash_attention", "attention"),
                     ("rmsnorm", "rmsnorm")):
        launches[name] += moon[op]

    # 8a. llama-3.2-vision, a full-width 20-layer cut: cross-attention to
    # vision tokens; 8b. musicgen-medium whole: embedding inputs
    zoo = (run_llama_vision(smi), run_musicgen(smi))
    for name, op in (("decode_attention", "decode_attention"),
                     ("emit_norm_logits", "emit_norm_logits"), ("flash_attention", "attention"),
                     ("rmsnorm", "rmsnorm")):
        launches[name] += sum(counts[op] for counts in zoo)

    # 9. The paper's Stream programs under the Lazy and Future evaluators on the card
    product, product_wall, primes, primes_wall = run_stream_phase(smi)

    # 10. Training: full-width OLMo-1B, the trainer, fault replay and the
    # planned backward; no kernel launches
    run_training(smi)

    # 12. The mesh layer on a one-rank NCCL group: collectives, the
    # elastic resume of step 10c's checkpoint, the dry run; 13, on the
    # same group, the pipelined demo step; 14, the StreamEngine, the sieve
    # and the product across its one-rank pod axis
    ranked = run_mesh_phase(smi, dict(engine=flash_tokens, b=stream_c, b_launches=b_launches,
                                      snapshot_c=snapshot_c,
                                      product=product, product_wall=product_wall,
                                      primes=primes, primes_wall=primes_wall))
    for name, op in (("decode_attention", "decode_attention"),
                     ("emit_norm_logits", "emit_norm_logits"), ("flash_attention", "attention")):
        launches[name] += ranked[op]

    source = {
        "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention/kernel.py:34"),
        "emit_norm_logits": ("src/repro_torch/kernels/csrc/emit_norm_logits.cu",
                             "src/repro/kernels/emit_norm_logits/kernel.py:45"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:32"),
        "ssd": ("src/repro_torch/kernels/csrc/ssd.cu", "src/repro/kernels/ssd/kernel.py:29"),
        "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm/kernel.py:18"),
    }
    record = [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], **results[name]}
        for name, (src, replaces) in source.items()
    ]
    print(f"step 11 (roofline and trace) took {sum(STEP11_SECONDS):.1f} s in "
          f"{len(STEP11_SECONDS)} parts", flush=True)
    print(f"chip_smoke.py took {time.perf_counter() - started:.1f} s", flush=True)
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
