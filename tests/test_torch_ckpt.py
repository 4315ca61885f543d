"""The port's training checkpoints, its train loop and its data pipeline:
the reference's own tests (tests/test_checkpoint_loop.py and the
checkpoint cases of tests/test_resilience.py) on the port, and
checkpoints that cross packages: a file either package writes restores in
the other, with the same keys, dtypes and bytes."""
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jax_ck
from repro.configs import colpali_hpc as jax_colpali_hpc
from repro.configs import lm_archs as jax_lm_archs
from repro.configs import registry as jax_registry
from repro.launch import train as jax_train_cli
from repro.models import colpali as jax_colpali
from repro.models import gnn as jax_gnn
from repro.models import recsys as jax_recsys
from repro.models import transformer as jax_transformer
from repro.optim import optimizer as jax_opt
from repro_torch import convert
from repro_torch.ckpt import checkpoint as ck
from repro_torch.configs import colpali_hpc, lm_archs
from repro_torch.data.pipeline import PrefetchPipeline, device_put_batch
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as T
from repro_torch.optim import optimizer as opt
from repro_torch.train import loop as train_loop

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
_jax_update = jax.jit(jax_opt.update, static_argnums=0)


@pytest.fixture
def tree():
    gen = torch.Generator().manual_seed(0)
    return {"a": torch.randn((8, 4), generator=gen),
            "nested": {"b": torch.arange(6, dtype=torch.int32).reshape(2, 3)},
            "scalar": torch.tensor(3.5)}


def _zeros_like(tree):
    return ck.map_with_paths(lambda _, x: torch.zeros_like(x), tree)


def _leaves(tree):
    return [x for _, x in ck.leaves_with_paths(tree)]


def test_save_restore_roundtrip(tmp_path, tree):
    path = ck.save(str(tmp_path), 7, tree)
    out = ck.restore(path, _zeros_like(tree))
    for a, b in zip(_leaves(tree), _leaves(out)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    assert ck.latest_step(str(tmp_path)) == 7


def test_uncommitted_checkpoint_rejected(tmp_path, tree):
    path = ck.save(str(tmp_path), 1, tree)
    os.remove(os.path.join(path, "COMMIT"))
    assert ck.latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        ck.restore(path, tree)


def test_shape_mismatch_rejected(tmp_path, tree):
    path = ck.save(str(tmp_path), 1, tree)
    bad = dict(tree)
    bad["a"] = torch.zeros((9, 4))
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore(path, bad)


def test_corrupt_checkpoint_fails_with_named_leaf(tmp_path):
    tree = {"w": np.arange(16, dtype=np.float32).reshape(4, 4),
            "b": np.ones((4,), np.float32)}
    path = ck.save(str(tmp_path), 1, tree)
    np.testing.assert_array_equal(ck.restore(path, tree)["w"], tree["w"])
    npz_path = os.path.join(path, "arrays.npz")
    with np.load(npz_path) as z:
        arrays = {k: z[k] for k in z.files}
    key = sorted(arrays)[0]
    arrays[key] = arrays[key] + 1             # corrupt one leaf on disk
    np.savez(npz_path, **arrays)
    with pytest.raises(ValueError, match=re.escape(
            f"checksum mismatch on leaf {key!r}")):
        ck.restore(path, tree)


def test_sigkill_mid_save_previous_step_restores(tmp_path):
    """A torch-only child saves step after step and is killed mid-write;
    the latest committed step restores."""
    code = f"""
import sys
import numpy as np
from repro_torch.ckpt import checkpoint as ckpt
assert "jax" not in sys.modules
tree = {{"w": np.zeros((256, 256), np.float32)}}
step = 0
while True:
    step += 1
    ckpt.save({str(tmp_path)!r}, step, tree)
    print("STEP", step, flush=True)
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().startswith("STEP")
        proc.stdout.readline()
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    step = ck.latest_step(str(tmp_path))
    assert step is not None and step >= 2
    tree = {"w": np.zeros((256, 256), np.float32)}
    restored = ck.restore(os.path.join(str(tmp_path), f"step_{step:08d}"),
                          tree)
    assert restored["w"].shape == (256, 256)


def test_manager_gc_and_resume(tmp_path, tree):
    mgr = ck.CheckpointManager(str(tmp_path), keep=2)
    for s in (10, 20, 30):
        mgr.save(s, ck.map_with_paths(lambda _, x: x + s, tree))
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path))
    assert steps == [20, 30]
    step, out = mgr.restore_latest(tree)
    assert step == 30
    torch.testing.assert_close(out["a"], tree["a"] + 30)
    assert mgr.last_save["step"] == 30
    assert mgr.last_save["bytes"] == ck.checkpoint_bytes(
        mgr.last_save["path"]) > 0


def test_async_save(tmp_path, tree):
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save_async(5, tree)
    tree["a"].add_(1.0)             # the snapshot was taken at the call
    mgr.wait()
    assert ck.latest_step(str(tmp_path)) == 5
    _, out = mgr.restore_latest(tree)
    torch.testing.assert_close(out["a"], tree["a"] - 1.0)


def test_async_save_error_is_raised_by_wait(tmp_path):
    """The background write's error surfaces on wait(), not before."""
    d = tmp_path / "ck"
    mgr = ck.CheckpointManager(str(d))
    mgr.save_async(1, {"w": torch.zeros(2, dtype=torch.bfloat16)})
    mgr.wait()
    shutil.rmtree(d)
    d.write_text("a file where the checkpoint directory was")
    mgr.save_async(2, {"w": torch.zeros(2)})
    with pytest.raises(OSError):
        mgr.wait()


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

def _toy_step(moment_dtype="fp32"):
    cfg = opt.AdamWConfig(lr=1e-2, weight_decay=0.0,
                          moment_dtype=moment_dtype)
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((3, 3), generator=gen)}
    batch = {"x": torch.randn((3, 16), generator=gen),
             "y": torch.randn((3, 16), generator=gen)}

    def step(p, s, b):
        loss, _, g = T.value_and_grad(
            lambda q: (torch.mean((q["w"] @ b["x"] - b["y"]) ** 2), {}), p)
        p, s, m = opt.update(cfg, g, s, p)
        return p, s, {"loss": loss, **m}

    return step, params, opt.init(cfg, params), batch


def _batches(batch):
    while True:
        yield batch


def _quiet(*_):
    pass


def test_loop_runs_and_checkpoints(tmp_path):
    step, params, state, batch = _toy_step()
    cfg = train_loop.LoopConfig(total_steps=20, ckpt_every=10,
                                ckpt_dir=str(tmp_path), log_every=0)
    out = train_loop.run(step, params, state, _batches(batch), cfg,
                         log_fn=_quiet)
    assert out["step"] == 20
    assert out["history"][-1]["loss"] < out["history"][0]["loss"]
    assert ck.latest_step(str(tmp_path)) == 20
    assert out["checkpoint"]["step"] == 20
    assert all(h["seconds"] > 0 and h["skipped"] == 0
               for h in out["history"])
    assert int(out["opt_state"].step) == 20


@pytest.mark.parametrize("moment_dtype", ["fp32", "int8"])
def test_loop_resumes_after_preemption_to_the_same_params(tmp_path,
                                                          moment_dtype):
    """A run stopped at step 10 and resumed from its checkpoint to step 20
    ends at the params and state of an uninterrupted 20-step run, bit for
    bit (the same batches)."""
    step, params, state, batch = _toy_step(moment_dtype)
    cfg = train_loop.LoopConfig(total_steps=10, ckpt_every=5,
                                ckpt_dir=str(tmp_path / "a"), log_every=0)
    out1 = train_loop.run(step, params, state, _batches(batch), cfg,
                          log_fn=_quiet)
    cfg2 = train_loop.LoopConfig(total_steps=20, ckpt_every=5,
                                 ckpt_dir=str(tmp_path / "a"), log_every=0)
    logs = []
    out2 = train_loop.run(step, params, state, _batches(batch), cfg2,
                          log_fn=logs.append)
    assert any("resumed from step 10" in m for m in logs)
    assert out2["step"] == 20 and len(out2["history"]) == 10
    assert out2["history"][0]["loss"] <= out1["history"][0]["loss"]
    whole = train_loop.run(step, params, state, _batches(batch),
                           train_loop.LoopConfig(
                               total_steps=20, ckpt_every=0,
                               ckpt_dir=str(tmp_path / "b"), log_every=0),
                           log_fn=_quiet)
    got = convert.train_tree(out2["params"], out2["opt_state"])
    want = convert.train_tree(whole["params"], whole["opt_state"])
    for (k, a), (_, b) in zip(ck.leaves_with_paths(got),
                              ck.leaves_with_paths(want)):
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_loop_nan_guard_skips_with_moments_and_step_unchanged(tmp_path):
    step, params, state, batch = _toy_step()
    calls = {"n": 0}
    seen = {}

    def poisoned(p, s, b):
        calls["n"] += 1
        p2, s2, m = step(p, s, b)
        if calls["n"] == 3:          # one bad step
            seen["before"] = convert.train_tree(p, s)
            m = dict(m)
            m["loss"] = torch.tensor(float("nan"))
            p2 = {k: v * float("nan") for k, v in p2.items()}
        return p2, s2, m

    def checked(p, s, b):
        out = guarded(p, s, b)
        if calls["n"] == 3:
            seen["after"] = convert.train_tree(out[0], out[1])
        return out

    guarded = train_loop.guard_nonfinite(poisoned)
    p, s = params, state
    for _ in range(5):
        p, s, m = checked(p, s, batch)
        if calls["n"] == 3:
            assert int(m["skipped"]) == 1
    for (k, a), (_, b) in zip(ck.leaves_with_paths(seen["before"]),
                              ck.leaves_with_paths(seen["after"])):
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert int(s.step) == 4            # 5 calls, one rolled back

    cfg = train_loop.LoopConfig(total_steps=6, ckpt_every=0,
                                ckpt_dir=str(tmp_path), log_every=0)
    calls["n"] = 0
    out = train_loop.run(poisoned, params, state, _batches(batch), cfg,
                         log_fn=_quiet)
    assert out["stats"]["skipped"] == 1
    assert int(out["opt_state"].step) == 5
    assert all(bool(torch.isfinite(v).all()) for v in out["params"].values())


def test_prefetch_pipeline_straggler_reserve():
    def slow_iter():
        yield {"i": 1}
        time.sleep(1.0)          # straggler
        yield {"i": 2}
        yield {"i": 3}

    pipe = PrefetchPipeline(slow_iter(), depth=1, timeout_s=0.2)
    got = [next(pipe)["i"] for _ in range(4)]
    assert got[0] == 1
    assert 1 in got[1:]          # the straggler window re-served batch 1
    assert pipe.stats["repeats"] >= 1
    pipe.close()
    assert not pipe._thread.is_alive()


def test_prefetch_pipeline_surfaces_errors_and_ends():
    def failing():
        yield {"x": torch.zeros(2)}
        raise RuntimeError("shard unreadable")

    pipe = PrefetchPipeline(failing(), depth=2)
    assert next(pipe)["x"].shape == (2,)     # made before the error
    for _ in range(2):
        with pytest.raises(RuntimeError, match="shard unreadable"):
            next(pipe)
    pipe.close()
    done = PrefetchPipeline(iter([{"x": 1}]), depth=2)
    assert next(done) == {"x": 1}
    with pytest.raises(StopIteration):
        next(done)
    done.close()


def test_device_put_batch_on_the_cpu_keeps_the_tensors():
    batch = {"x": torch.arange(4)}
    out = device_put_batch(batch, "cpu")
    assert out["x"] is batch["x"]


# ---------------------------------------------------------------------------
# checkpoints across packages
# ---------------------------------------------------------------------------

def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _reference_train_state(arch, moment_dtype, steps=2):
    """The reference's (params, AdamWState) after ``steps`` AdamW updates
    on random grads, as host arrays, with its config and the port's."""
    if arch == "colpali":
        jcfg = jax_colpali_hpc.COLPALI_HPC.smoke_config.encoder
        tcfg = colpali_hpc.COLPALI_HPC.smoke_config.encoder
        params = _host(jax_colpali.init(jax.random.PRNGKey(0), jcfg))
    else:
        jcfg = jax_lm_archs.GLM4_9B.smoke_config
        tcfg = lm_archs.GLM4_9B.smoke_config
        params = _host(jax_transformer.init(jax.random.PRNGKey(0), jcfg))
    ocfg = jax_opt.AdamWConfig(moment_dtype=moment_dtype)
    state = jax_opt.init(ocfg, params)
    rng = np.random.default_rng(1)
    for _ in range(steps):
        grads = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
            np.float32), params)
        params, state, _ = _jax_update(ocfg, grads, state, params)
    return _host(params), _host(state), tcfg


def _port_model(arch, tcfg, params):
    if arch == "colpali":
        return convert.colpali_params_from_numpy(params, tcfg, device="cpu")
    return convert.lm_params_from_numpy(params, tcfg, device="cpu")


def _npz(path):
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("arch", ["lm", "colpali"])
@pytest.mark.parametrize("moment_dtype", ["fp32", "int8"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, arch,
                                                   moment_dtype):
    """A checkpoint the reference writes of (params, AdamWState) restores
    into the port's named tensors and optimizer state, every value equal,
    and the port's save of what it restored is the same file: keys,
    dtypes, bytes and the meta's leaves."""
    params, state, tcfg = _reference_train_state(arch, moment_dtype)
    jpath = jax_ck.save(str(tmp_path / "jax"), 2, (params, state))
    model = _port_model(arch, tcfg, params)
    like = T.params_of(model)
    fresh = opt.init(opt.AdamWConfig(moment_dtype=moment_dtype), like)
    tree = ck.restore(jpath, convert.train_template(like, fresh))
    p, s = convert.train_state_from_tree(tree, like)
    assert int(s.step) == 2 and s.step.dtype == torch.int32
    assert isinstance(s.m[next(iter(like))], opt.QMoment) == (
        moment_dtype == "int8")
    tpath = ck.save(str(tmp_path / "port"), 2, convert.train_tree(p, s))
    want, got = _npz(jpath), _npz(tpath)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].tobytes() == want[key].tobytes(), key
    with open(os.path.join(jpath, "meta.json")) as f:
        jmeta = json.load(f)["leaves"]
    with open(os.path.join(tpath, "meta.json")) as f:
        tmeta = json.load(f)["leaves"]
    assert jmeta == tmeta


@pytest.mark.parametrize("moment_dtype", ["fp32", "int8"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, moment_dtype):
    """The port trains 2 steps and saves; the reference restores the file
    into its own (params, AdamWState) template, every value equal to the
    port's."""
    jcfg = jax_lm_archs.QWEN2_1_5B.smoke_config
    tcfg = lm_archs.QWEN2_1_5B.smoke_config
    jparams = _host(jax_transformer.init(jax.random.PRNGKey(5), jcfg))
    jstate = jax_opt.init(jax_opt.AdamWConfig(moment_dtype=moment_dtype),
                          jparams)
    model = convert.lm_params_from_numpy(jparams, tcfg, device="cpu")
    ocfg = opt.AdamWConfig(moment_dtype=moment_dtype)
    p = T.params_of(model)
    s = opt.init(ocfg, p)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        tok = torch.randint(0, tcfg.vocab, (2, 16), generator=gen)
        p, s, _ = T.train_step(model, p, s, {"tokens": tok,
                                             "targets": tok}, ocfg)
    path = ck.save(str(tmp_path), 2, convert.train_tree(p, s))
    back = _host(jax_ck.restore(path, (jparams, jstate)))
    want = convert.train_tree(p, s)
    flat_back = dict(ck.leaves_with_paths(back))
    flat_want = dict(ck.leaves_with_paths(want))
    assert sorted(flat_back) == sorted(flat_want)
    for key, val in flat_want.items():
        np.testing.assert_array_equal(flat_back[key], val, err_msg=key)
    assert int(back[1].step) == 2


def test_train_tree_keys_are_the_references(tmp_path):
    """The port's keys for an LM state are jax.tree_util.keystr's over the
    reference's (params, AdamWState)."""
    params, state, tcfg = _reference_train_state("lm", "int8", steps=0)
    flat, _ = jax.tree_util.tree_flatten_with_path((params, state))
    want = [jax.tree_util.keystr(k) for k, _ in flat]
    like = T.params_of(_port_model("lm", tcfg, params))
    got = [k for k, _ in ck.leaves_with_paths(convert.train_tree(
        like, opt.init(opt.AdamWConfig(moment_dtype="int8"), like)))]
    assert got == want
    assert "[0]['blocks']['attn']['wq']" in got
    assert "[1].m['embed'].q" in got and "[1].step" in got


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_train_cli_trains_checkpoints_and_resumes(tmp_path, capsys):
    args = ["--arch", "qwen2-1.5b", "--smoke", "--batch", "2", "--seq", "16",
            "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "3"]
    out = train_cli.main(args + ["--steps", "6"])
    assert out["step"] == 6 and len(out["history"]) == 6
    assert ck.latest_step(str(tmp_path)) == 6
    assert out["pipeline"]["served"] == 6
    out2 = train_cli.main(args + ["--steps", "8"])
    assert out2["step"] == 8 and len(out2["history"]) == 2
    assert "final loss" in capsys.readouterr().out


def test_train_cli_colpali_smoke(tmp_path):
    out = train_cli.main(["--arch", "colpali-hpc", "--smoke", "--batch", "3",
                          "--steps", "2", "--device", "cpu", "--ckpt-dir",
                          str(tmp_path), "--ckpt-every", "0"])
    assert out["step"] == 2
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert set(out["history"][0]) >= {"loss", "acc", "lr", "grad_norm",
                                      "skipped", "seconds"}


@pytest.mark.parametrize("arch", ["pna", "dlrm-mlperf", "dcn-v2", "din",
                                  "dien"])
def test_train_cli_gnn_and_recsys_checkpoints_cross_packages(tmp_path,
                                                             arch):
    """The port's CLI trains 2 steps and its checkpoint restores in the
    reference's (params, AdamWState), every value equal; the reference's
    CLI trains 2 steps and the port's resumes that run from step 2."""
    args = ["--arch", arch, "--smoke", "--batch", "4", "--ckpt-every", "0"]
    out = train_cli.main(args + ["--steps", "2", "--device", "cpu",
                                 "--ckpt-dir", str(tmp_path / "port")])
    assert out["step"] == 2
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    jspec = jax_registry.get(arch)
    init = jax_gnn.init if jspec.family == "gnn" else jax_recsys.init
    jparams = _host(init(jax.random.PRNGKey(0), jspec.smoke_config))
    template = (jparams, jax_opt.init(jax_opt.AdamWConfig(), jparams))
    back = _host(jax_ck.restore(
        out["checkpoint"]["path"], template))
    want = dict(ck.leaves_with_paths(convert.train_tree(out["params"],
                                                        out["opt_state"])))
    got = dict(ck.leaves_with_paths(back))
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        np.testing.assert_array_equal(got[key], val, err_msg=key)

    jax_train_cli.main(args + ["--steps", "2", "--ckpt-dir",
                               str(tmp_path / "jax")])
    res = train_cli.main(args + ["--steps", "3", "--device", "cpu",
                                 "--ckpt-dir", str(tmp_path / "jax")])
    assert res["step"] == 3 and len(res["history"]) == 1
