"""repro_torch's training substrate against the JAX package, on the CPU.

The port counterparts of tests/test_train_substrate.py's classes:
AdamW (against the JAX update and a numpy reference), gradient
compression, the step-keyed data pipeline (batches equal bit for bit),
the checkpointer in the reference's on-disk layout (a JAX-written
checkpoint restores into the port and a port-written one reads in the
JAX package, bf16 leaves included) and ``ResilientLoop``.  Also the two
memory faults repaired with this slice: the pytree walkers' reference
cycles and the first remat backward's frames.
"""
import gc
import json
import os
import subprocess
import sys
import weakref

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _hypothesis_stub import hypothesis, st  # skips @given tests offline
from _torch_one_thread import one_torch_thread  # noqa: F401  (one torch thread)
from repro.data import pipeline as JD
from repro.train import compression as JC
from repro.train import optimizer as JO
from repro.train.checkpoint import Checkpointer as JaxCheckpointer
from repro_torch import pytree as P
from repro_torch.data.pipeline import DataConfig, PrefetchIterator, host_shard, make_source
from repro_torch.models.params import abstract_params, cast_layout, ParamSpec
from repro_torch.train import compression
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.fault import FaultConfig, ResilientLoop
from repro_torch.train.optimizer import (
    AdamWConfig,
    abstract_opt_state,
    adamw_update,
    global_norm,
    init_opt_state,
    lr_schedule,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def t(x):
    return torch.from_numpy(np.asarray(x))


class TestOptimizer:
    def _numpy_adamw(self, p, g, m, v, step, cfg):
        gnorm = np.sqrt(sum(np.sum(np.square(x)) for x in g.values()))
        scale = min(1.0, cfg.clip_norm / max(gnorm, 1e-9))
        lr = float(lr_schedule(torch.tensor(step), cfg))
        out_p, out_m, out_v = {}, {}, {}
        for k in p:
            gg = g[k] * scale
            out_m[k] = cfg.beta1 * m[k] + (1 - cfg.beta1) * gg
            out_v[k] = cfg.beta2 * v[k] + (1 - cfg.beta2) * gg * gg
            mh = out_m[k] / (1 - cfg.beta1**step)
            vh = out_v[k] / (1 - cfg.beta2**step)
            upd = mh / (np.sqrt(vh) + cfg.eps) + cfg.weight_decay * p[k]
            out_p[k] = p[k] - lr * upd
        return out_p, out_m, out_v

    def test_matches_numpy_reference(self):
        rng = np.random.default_rng(0)
        cfg = AdamWConfig(learning_rate=1e-2, warmup_steps=0)
        p = {"a": rng.normal(size=(4, 3)).astype(np.float32),
             "b": rng.normal(size=(5,)).astype(np.float32)}
        g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p.items()}
        params = {k: t(v) for k, v in p.items()}
        opt = init_opt_state(params, cfg)
        new_p, new_opt, _ = adamw_update(params, {k: t(v) for k, v in g.items()}, opt, cfg)
        ref_p, ref_m, _ = self._numpy_adamw(
            p, g, {k: np.zeros_like(v) for k, v in p.items()},
            {k: np.zeros_like(v) for k, v in p.items()}, 1, cfg,
        )
        for k in p:
            np.testing.assert_allclose(new_p[k].numpy(), ref_p[k], rtol=2e-5, atol=1e-6)
            np.testing.assert_allclose(new_opt["m"][k].numpy(), ref_m[k], rtol=2e-5, atol=1e-6)
        assert int(new_opt["step"]) == 1 and new_opt["step"].dtype == torch.int32

    @pytest.mark.parametrize("moments", ["f32", "bf16"])
    def test_three_updates_match_jax(self, moments):
        """Params, moments, grad norm and lr of three updates against the
        JAX package's (fp32 params; fp32 or bf16 moments)."""
        rng = np.random.default_rng(1)
        jdt, tdt = {"f32": (jnp.float32, torch.float32),
                    "bf16": (jnp.bfloat16, torch.bfloat16)}[moments]
        jcfg = JO.AdamWConfig(learning_rate=1e-2, warmup_steps=2, total_steps=5,
                              moment_dtype=jdt, clip_norm=0.5)
        cfg = AdamWConfig(learning_rate=1e-2, warmup_steps=2, total_steps=5,
                          moment_dtype=tdt, clip_norm=0.5)
        p = {"a": rng.normal(size=(6, 3)).astype(np.float32),
             "b": {"c": rng.normal(size=(7,)).astype(np.float32)}}
        jp, tp = jax.tree.map(jnp.asarray, p), P.tree_map(t, p)
        jo, to = JO.init_opt_state(jp, jcfg), init_opt_state(tp, cfg)
        for _ in range(3):
            g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), p)
            jp, jo, jm = JO.adamw_update(jp, jax.tree.map(jnp.asarray, g), jo, jcfg)
            tp, to, tm = adamw_update(tp, P.tree_map(t, g), to, cfg)
            for k in ("grad_norm", "learning_rate"):
                np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
        for a, b in zip(jax.tree.leaves((jp, jo)), P.leaves((tp, to))):
            np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32),
                                       rtol=1e-5, atol=1e-6)

    def test_clip_caps_update(self):
        cfg = AdamWConfig(clip_norm=1e-3, weight_decay=0.0, warmup_steps=0)
        params = {"w": torch.ones(8)}
        opt = init_opt_state(params, cfg)
        _, _, metrics = adamw_update(params, {"w": torch.full((8,), 100.0)}, opt, cfg)
        assert float(metrics["grad_norm"]) > 100

    def test_bf16_moments_roundtrip(self):
        cfg = AdamWConfig(moment_dtype=torch.bfloat16)
        params = {"w": torch.ones(4)}
        opt = init_opt_state(params, cfg)
        assert opt["m"]["w"].dtype == torch.bfloat16
        new_p, new_opt, _ = adamw_update(params, {"w": torch.ones(4) * 0.1}, opt, cfg)
        assert new_opt["v"]["w"].dtype == torch.bfloat16
        assert bool(torch.isfinite(new_p["w"]).all())
        assert torch.equal(params["w"], torch.ones(4))  # functional

    def test_lr_schedule_matches_jax(self):
        cfg = AdamWConfig(learning_rate=1.0, warmup_steps=10, total_steps=100)
        jcfg = JO.AdamWConfig(learning_rate=1.0, warmup_steps=10, total_steps=100)
        for s in [0, 5, 10, 37, 100, 150]:
            got = float(lr_schedule(torch.tensor(s, dtype=torch.int32), cfg))
            want = float(JO.lr_schedule(jnp.asarray(s, jnp.int32), jcfg))
            assert got == pytest.approx(want, rel=1e-6, abs=1e-7), s
        assert float(lr_schedule(torch.tensor(0), cfg)) == 0.0

    def test_global_norm_and_abstract_state(self):
        tree = {"a": torch.ones(3, 4), "b": torch.full((2,), 2.0, dtype=torch.bfloat16)}
        assert float(global_norm(tree)) == pytest.approx(np.sqrt(12 + 8))
        layout = {"w": ParamSpec((3, 4), (None, None)), "n": {"s": ParamSpec((4,), (None,))}}
        abstract = abstract_params(cast_layout(layout, torch.float32))
        assert all(x.is_meta and x.dtype == torch.float32 for x in P.leaves(abstract))
        opt = abstract_opt_state(abstract, AdamWConfig(moment_dtype=torch.bfloat16))
        assert opt["m"]["w"].shape == (3, 4) and opt["v"]["n"]["s"].dtype == torch.bfloat16
        assert opt["step"].shape == () and opt["step"].is_meta


class TestCompression:
    @hypothesis.given(st.integers(0, 2**31 - 1))
    @hypothesis.settings(max_examples=10, deadline=None)
    def test_error_feedback_preserves_sum(self, seed):
        rng = np.random.default_rng(seed)
        grads = [rng.normal(size=(64,)).astype(np.float32) * 1e-3 for _ in range(30)]
        err = None
        total_q = np.zeros(64, np.float64)
        for g in grads:
            q, err = compression.compress_decompress({"g": t(g)}, err)
            total_q += q["g"].numpy().astype(np.float64)
        np.testing.assert_allclose(total_q + err["g"].numpy(), np.sum(grads, axis=0), atol=1e-5)

    def test_equals_jax_bitwise(self):
        rng = np.random.default_rng(2)
        err, jerr = None, None
        for _ in range(5):
            g = {"a": rng.normal(size=(33,)).astype(np.float32),
                 "b": rng.normal(size=(4, 5)).astype(np.float32) * 1e-3}
            q, err = compression.compress_decompress(P.tree_map(t, g), err)
            jq, jerr = JC.compress_decompress(jax.tree.map(jnp.asarray, g), jerr)
            for a, b in zip(jax.tree.leaves((jq, jerr)), P.leaves((q, err))):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))

    def test_compression_is_bf16_quantized(self):
        g = {"g": torch.tensor([1.0 + 1e-4])}
        q, err = compression.compress_decompress(g, None)
        assert float(q["g"][0]) != float(g["g"][0])
        assert abs(float(q["g"][0] + err["g"][0]) - float(g["g"][0])) < 1e-9
        abstract = compression.init_error_state({"g": torch.empty(3, dtype=torch.bfloat16)})
        assert abstract["g"].is_meta and abstract["g"].dtype == torch.float32


class TestDataPipeline:
    @pytest.mark.parametrize("step", [0, 5])
    def test_batches_equal_jax(self, step):
        kw = dict(seq_len=16, global_batch=4, seed=3, vocab_size=97)
        got = make_source(DataConfig(**kw)).batch(step)
        want = JD.make_source(JD.DataConfig(**kw)).batch(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])

    def test_step_keyed_determinism(self):
        src = make_source(DataConfig(seq_len=16, global_batch=4, seed=3))
        b1, b2 = src.batch(5), src.batch(5)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
        assert not np.array_equal(b1["tokens"], src.batch(6)["tokens"])

    def test_labels_are_shifted_tokens(self):
        b = make_source(DataConfig(seq_len=16, global_batch=2)).batch(0)
        assert b["tokens"].shape == b["labels"].shape == (2, 16)

    def test_prefetch_iterator_order_and_seek(self):
        src = make_source(DataConfig(seq_len=8, global_batch=2))
        it = PrefetchIterator(src, start_step=0, depth=2)
        np.testing.assert_array_equal(next(it)["tokens"], src.batch(0)["tokens"])
        np.testing.assert_array_equal(next(it)["tokens"], src.batch(1)["tokens"])
        it.seek(10)
        np.testing.assert_array_equal(next(it)["tokens"], src.batch(10)["tokens"])

    def test_host_shard_slices_rows(self):
        batch = {"tokens": np.arange(32).reshape(8, 4)}
        np.testing.assert_array_equal(
            host_shard(batch, process_index=1, process_count=2)["tokens"], batch["tokens"][4:])
        np.testing.assert_array_equal(host_shard(batch)["tokens"], batch["tokens"])

    def test_file_source_equals_jax(self, tmp_path):
        path = str(tmp_path / "toks.bin")
        np.arange(10000, dtype=np.uint16).tofile(path)
        kw = dict(seq_len=8, global_batch=2, kind="file", path=path)
        b = make_source(DataConfig(**kw)).batch(1)
        assert b["tokens"].shape == (2, 8)
        np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
        np.testing.assert_array_equal(b["tokens"], JD.make_source(JD.DataConfig(**kw)).batch(1)["tokens"])


def _train_state(rng, dtype=torch.bfloat16):
    """A small params + AdamW state tree with bf16 and fp32 leaves."""
    params = {"embed": {"embedding": t(rng.normal(size=(11, 4)).astype(np.float32)).to(dtype)},
              "blocks": {"block0": {"w": t(rng.normal(size=(2, 4, 4)).astype(np.float32))}}}
    opt = init_opt_state(params, AdamWConfig(moment_dtype=torch.bfloat16))
    opt["m"] = P.tree_map(lambda x: torch.randn(x.shape).to(x.dtype), opt["m"])
    opt["v"] = P.tree_map(lambda x: torch.rand(x.shape).to(x.dtype), opt["v"])
    opt["step"] = torch.tensor(7, dtype=torch.int32)
    return {"params": params, "opt_state": opt}


def _to_jax(tree):
    return jax.tree.map(
        lambda x: jnp.asarray(x.float().numpy()).astype(
            {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32,
             torch.int32: jnp.int32}[x.dtype]), tree)


def _bits(x):
    """A leaf's raw bytes (JAX or torch), to compare bit for bit."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes() if x.dim() else \
            x.reshape(1).view(torch.uint8).numpy().tobytes()
    return np.asarray(x).tobytes()


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path), keep=2)
        state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
                 "opt_state": {"step": torch.tensor(7, dtype=torch.int32)}}
        ckpt.save(7, state, blocking=True)
        restored, step = ckpt.restore(state)
        assert step == 7
        assert torch.equal(restored["params"]["w"], state["params"]["w"])
        assert restored["opt_state"]["step"].shape == () and int(restored["opt_state"]["step"]) == 7

    def test_gc_keeps_last_k(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path), keep=2)
        for s in (1, 2, 3, 4):
            ckpt.save(s, {"x": torch.zeros(2)}, blocking=True)
        assert ckpt.all_steps() == [3, 4]

    def test_async_write_overlaps(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path))
        ckpt.save(1, {"x": torch.zeros((256, 256))})  # non-blocking
        assert ckpt.latest_step_or_inflight() == 1
        ckpt.wait()
        assert ckpt.latest_step() == 1

    def test_atomicity_no_partial_dirs(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path))
        ckpt.save(3, {"x": torch.ones(4)}, blocking=True)
        assert all(".tmp" not in n for n in os.listdir(tmp_path))

    def test_crashed_write_tmp_dirs_never_restore(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path))
        ckpt.save(2, {"x": torch.ones(4)}, blocking=True)
        for proc in (0, 3):
            crashed = tmp_path / f"step_{9:08d}.tmp{proc}"
            crashed.mkdir()
            (crashed / "manifest.json").write_text('{"step": 9, "process": %d}' % proc)
        assert ckpt.all_steps() == [2] and ckpt.latest_step() == 2
        _, step = ckpt.restore({"x": torch.ones(4)})
        assert step == 2

    def test_layout_equals_jax(self, tmp_path):
        """Same directory, file and key names, manifest keys and, array by
        array, the same dtype descriptor and bytes as the JAX package
        writes for the same state (bf16 as 2-byte records)."""
        state = _train_state(np.random.default_rng(0))
        Checkpointer(str(tmp_path / "port")).save(3, state, blocking=True)
        JaxCheckpointer(str(tmp_path / "jax")).save(3, _to_jax(state), blocking=True)
        names = {}
        for side in ("port", "jax"):
            d = tmp_path / side / "step_00000003"
            assert sorted(os.listdir(d)) == ["arrays_p0.npz", "manifest.json"]
            manifest = json.loads((d / "manifest.json").read_text())
            assert sorted(manifest) == ["num_arrays", "process", "step", "time"]
            with np.load(d / "arrays_p0.npz") as z:
                names[side] = {k: (z[k].dtype.str, z[k].shape, z[k].tobytes()) for k in z.files}
        assert names["port"] == names["jax"]
        assert "['opt_state']['m']['embed']['embedding']" in names["port"]
        assert names["port"]["['params']['embed']['embedding']"][0] == "|V2"

    def test_jax_checkpoint_restores_into_the_port(self, tmp_path):
        state = _train_state(np.random.default_rng(1))
        jstate = _to_jax(state)
        JaxCheckpointer(str(tmp_path)).save(5, jstate, blocking=True)
        template = P.tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), state)
        restored, step = Checkpointer(str(tmp_path)).restore(template, device="cpu")
        assert step == 5
        for a, b in zip(jax.tree.leaves(jstate), P.leaves(restored)):
            assert b.dtype == {jnp.dtype(jnp.bfloat16): torch.bfloat16,
                               jnp.dtype(jnp.float32): torch.float32,
                               jnp.dtype(jnp.int32): torch.int32}[a.dtype]
            assert tuple(b.shape) == a.shape and _bits(b) == _bits(a)

    def test_port_checkpoint_reads_in_the_jax_package(self, tmp_path):
        """The JAX ``Checkpointer.restore`` restores a port-written
        checkpoint bitwise for every fp32 and int32 leaf.  It cannot
        restore a bf16 leaf from its own checkpoints either (numpy loads
        the 2-byte records as ``|V2``, which ``jax.device_put`` refuses:
        ROADMAP C); those records, viewed as ``ml_dtypes.bfloat16`` as
        the JAX package holds them, are its bf16 leaves bit for bit."""
        state = _train_state(np.random.default_rng(2), dtype=torch.float32)
        state["opt_state"]["m"] = P.tree_map(lambda x: x.float(), state["opt_state"]["m"])
        state["opt_state"]["v"] = P.tree_map(lambda x: x.float(), state["opt_state"]["v"])
        Checkpointer(str(tmp_path)).save(4, state, blocking=True)
        jstate = _to_jax(state)
        restored, step = JaxCheckpointer(str(tmp_path)).restore(jstate)
        assert step == 4
        for a, b in zip(jax.tree.leaves(restored), P.leaves(state)):
            assert _bits(a) == _bits(b)
        bf = _train_state(np.random.default_rng(3))
        Checkpointer(str(tmp_path / "bf16")).save(4, bf, blocking=True)
        with np.load(tmp_path / "bf16" / "step_00000004" / "arrays_p0.npz") as z:
            for key, leaf in P.flatten_with_paths(bf):
                got = z[key]
                if leaf.dtype == torch.bfloat16:
                    got = got.view(ml_dtypes.bfloat16)
                    want = np.asarray(jnp.asarray(leaf.float().numpy()).astype(jnp.bfloat16))
                    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
                else:
                    assert got.tobytes() == _bits(leaf)
        with pytest.raises(TypeError, match="V2"):
            JaxCheckpointer(str(tmp_path / "bf16")).restore(_to_jax(bf))


    def test_read_arrays_equals_np_load(self, tmp_path):
        """The direct reader gives ``np.load``'s arrays for a JAX-written
        checkpoint and for a compressed file (read through zipfile)."""
        from repro_torch.train.checkpoint import read_arrays

        rng = np.random.default_rng(4)
        JaxCheckpointer(str(tmp_path)).save(1, _to_jax(_train_state(rng)), blocking=True)
        path = tmp_path / "step_00000001" / "arrays_p0.npz"
        np.savez_compressed(tmp_path / "c.npz", a=rng.normal(size=(3, 5)),
                            b=np.asfortranarray(rng.normal(size=(4, 2))), s=np.int32(3))
        for p in (path, tmp_path / "c.npz"):
            got = read_arrays(str(p))
            with np.load(p) as want:
                assert sorted(got) == sorted(want.files)
                for k in want.files:
                    assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
                    assert got[k].tobytes() == want[k].tobytes()


class TestFaultTolerance:
    def _mini_step(self):
        def step(params, opt, batch):
            params = {"w": params["w"] - 0.1 * batch["g"]}
            return params, opt, {"loss": torch.sum(params["w"] ** 2)}
        return step

    def _run(self, tmp_path, every, crash_at, steps, name="c"):
        loop = ResilientLoop(self._mini_step(), Checkpointer(str(tmp_path / name)),
                             FaultConfig(checkpoint_every=every, max_restarts=2))
        crashed = {"done": False}

        def injector(step):
            if step == crash_at and not crashed["done"]:
                crashed["done"] = True
                raise RuntimeError("simulated node failure")

        out = loop.run({"w": torch.ones(2)}, {}, lambda s: {"g": torch.ones(2) * (s + 1)},
                       num_steps=steps, fail_injector=injector)
        return loop, out

    def test_restart_recovers_and_replays_bitwise(self, tmp_path):
        loop, (params, _, step, history) = self._run(tmp_path, 2, 3, 5)
        assert step == 5 and loop.stats["restarts"] == 1 and len(loop.restore_seconds) == 1
        _, (clean, _, _, _) = self._run(tmp_path, 100, -1, 5, name="clean")
        assert torch.equal(params["w"], clean["w"])

    def test_restart_history_counts_each_step_once(self, tmp_path):
        loop, (_, _, step, history) = self._run(tmp_path, 2, 3, 5)
        assert step == 5
        assert [h["step"] for h in history] == [0, 1, 2, 3, 4]
        assert loop.stats["steps"] == 5

    def test_restart_before_any_checkpoint_truncates_history(self, tmp_path):
        loop, (_, _, step, history) = self._run(tmp_path, 100, 2, 4)
        assert step == 4
        assert [h["step"] for h in history] == [0, 1, 2, 3]
        assert loop.stats["steps"] == 4 and loop.stats["restarts"] == 1

    def test_final_checkpoint_written_once(self, tmp_path, monkeypatch):
        """The last step's periodic save is the final checkpoint; the
        loop does not write the same step again (the reference does)."""
        saves = []
        real = Checkpointer.save
        monkeypatch.setattr(Checkpointer, "save",
                            lambda self, s, st, blocking=False: (saves.append(s),
                                                                 real(self, s, st, blocking)))
        self._run(tmp_path, 2, -1, 4)
        assert saves == [2, 4]
        saves.clear()
        self._run(tmp_path, 3, -1, 4, name="d")
        assert saves == [3, 4]

    def test_straggler_detection(self, tmp_path):
        seen = []
        loop = ResilientLoop(self._mini_step(), Checkpointer(str(tmp_path)),
                             FaultConfig(straggler_factor=1.5),
                             on_straggler=lambda s, ratio: seen.append((s, ratio)))
        loop._track_time(0, 0.1)
        loop._track_time(1, 0.1)
        loop._track_time(2, 1.0)  # straggler
        assert loop.stats["stragglers"] == 1 and seen[0][0] == 2

    def test_heartbeat_written(self, tmp_path):
        hb = str(tmp_path / "hb")
        loop = ResilientLoop(self._mini_step(), Checkpointer(str(tmp_path / "c")),
                             FaultConfig(heartbeat_path=hb, checkpoint_every=100))
        loop.run({"w": torch.ones(2)}, {}, lambda s: {"g": torch.ones(2)}, num_steps=2)
        assert os.path.exists(hb)


def test_pytree_walkers_hold_no_leaves_in_a_cycle():
    """``flatten``, ``unflatten`` and ``flatten_with_paths`` leave no
    reference cycle that would keep the leaves alive until the cyclic
    garbage collector runs."""
    gc.collect()
    gc.disable()
    try:
        x = torch.ones(3)
        ref = weakref.ref(x)
        leaves, td = P.flatten({"a": [x, (1, 2)], "b": None})
        P.flatten_with_paths(P.unflatten(td, leaves))
        del x, leaves
        assert ref() is None
    finally:
        gc.enable()


def test_first_remat_backward_keeps_no_frames():
    """In a fresh process, the first backward through a remat forward
    leaves no frame of the train step alive (torch.utils.checkpoint's
    first call imports torch._dynamo, and that import kept every calling
    frame, with its tensors, for the life of the process)."""
    code = """
import gc, torch
gc.disable()
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.models import transformer as T
from repro_torch.models.params import init_params
from repro_torch.train import train_step as TS
cfg = smoke_config(get_config("olmo-1b")).with_overrides(num_layers=2, d_model=64, d_ff=256, vocab_size=512)
p = init_params(T.model_layout(cfg), device="cpu")
b = {"tokens": torch.randint(0, 512, (2, 32)), "labels": torch.randint(0, 512, (2, 32))}
TS.value_and_grad(p, cfg, b, TS.TrainConfig(remat=True))
names = [o.f_code.co_name for o in gc.get_objects() if type(o).__name__ == "frame"]
print(sum(n in ("forward", "lm_loss", "value_and_grad") for n in names))
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         stdin=subprocess.DEVNULL, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-1] == "0"
