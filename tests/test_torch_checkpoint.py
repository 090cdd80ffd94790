"""Port parity: checkpointing and the training loop (``repro_torch/train/
{checkpoint,loop}.py``, ``launch/train.py``) against the JAX package's.

Each package reads the other's checkpoints exactly (same layout, same leaf
keys): a state the reference saves restores into the port bit for bit, and
the reverse. The rest mirrors ``tests/test_checkpoint.py`` (round trip,
retention, atomicity, shape mismatch, async, loop resume, preemption, the
straggler detector, restore onto another dtype and device), and the CLI
trains, checkpoints and resumes on the CPU. Every comparison is exact.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.models import reduced as jreduced
from repro.train import adamw_init as jadamw_init
from repro.train import checkpoint as JC
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import get_config
from repro_torch.models import init_params, opt_state_from_numpy, params_from_numpy, reduced
from repro_torch.train import adamw_init, make_train_step
from repro_torch.train import checkpoint as C
from repro_torch.train.loop import LoopConfig, PreemptionGuard, StragglerDetector, train_loop
from repro_torch.utils import tree_leaves, tree_map
from torch_helpers import jax_tree_to_numpy

ROOT = Path(__file__).resolve().parents[1]


def _state(x=1.0):
    return {
        "params": {"w": torch.full((4, 4), x, dtype=torch.float32), "b": torch.zeros((4,), dtype=torch.bfloat16)},
        "opt": {"step": torch.tensor(7, dtype=torch.int32)},
    }


def _bits(t):
    """A leaf's dtype name and bytes (bf16 through its int16 bits)."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.detach().cpu().view(torch.int16).numpy().tobytes()
        return str(t.dtype).split(".")[-1], t.detach().cpu().numpy().tobytes()
    a = np.asarray(t)
    if a.dtype.name == "bfloat16":
        return "bfloat16", a.view(np.uint16).view(np.int16).tobytes()
    return a.dtype.name, a.tobytes()


def _trained_states():
    """A reduced bf16 llama's params and AdamW state after one train step
    in each package, from the same weights: {"params", "opt"} trees."""
    kw = dict(d_model=32, n_layers=2, vocab=64, param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg, tcfg = jreduced(jget_config("llama3.2-3b"), **kw), reduced(get_config("llama3.2-3b"), **kw)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    batch = {"tokens": np.arange(64).reshape(4, 16) % 64, "labels": (np.arange(64).reshape(4, 16) + 1) % 64}
    jp1, jo1, _ = jax.jit(jmake_train_step(jcfg, lr=1e-2))(jp, jadamw_init(jp),
                                                          {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()})
    tp = params_from_numpy(jax_tree_to_numpy(jp), device="cpu")
    tp1, to1, _ = make_train_step(tcfg, lr=1e-2)(tp, adamw_init(tp),
                                                 {k: torch.from_numpy(v.astype(np.int32)) for k, v in batch.items()})
    return {"params": jp1, "opt": jo1}, {"params": tp1, "opt": to1}, tcfg


def test_leaf_keys_and_order_are_jax_s():
    jstate, tstate, _ = _trained_states()
    want = [k for k, _ in JC._leaf_paths(jstate)]
    assert [k for k, _ in C.leaf_paths(tstate)] == want
    assert "['opt']/.step" in want and any(k.startswith("['opt']/.m/['stages']/[0]/") for k in want)


def test_jax_checkpoint_restores_into_the_port_exactly(tmp_path):
    jstate, tstate, _ = _trained_states()
    JC.save(str(tmp_path), 1, jstate)
    template = {"params": tree_map(torch.zeros_like, tstate["params"]), "opt": adamw_init(tstate["params"])}
    out = C.restore(str(tmp_path), 1, template)
    for (k, got), (_, want) in zip(C.leaf_paths(out), JC._leaf_paths(jstate)):
        assert _bits(got) == _bits(want), k
    # and through opt_state_from_numpy the same state carries across in memory
    carried = opt_state_from_numpy(jax.tree.map(np.asarray, jstate["opt"]), device="cpu")
    for (k, a), (_, b) in zip(C.leaf_paths(carried), C.leaf_paths(out["opt"])):
        assert _bits(a) == _bits(b), k


def test_port_checkpoint_restores_into_jax_exactly(tmp_path):
    jstate, tstate, _ = _trained_states()
    C.save(str(tmp_path), 2, tstate)
    out = JC.restore(str(tmp_path), 2, jax.tree.map(jnp.zeros_like, jstate))
    for (k, got), (_, want) in zip(JC._leaf_paths(out), C.leaf_paths(tstate)):
        assert _bits(got) == _bits(want), k
        assert np.asarray(got).dtype.name == _bits(want)[0], k


def test_save_restore_roundtrip(tmp_path):
    s = _state(3.5)
    C.save(str(tmp_path), 10, s)
    out = C.restore(str(tmp_path), 10, tree_map(torch.zeros_like, s))
    for a, b in zip(tree_leaves(out), tree_leaves(s)):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_latest_and_retention(tmp_path):
    for step in (1, 2, 3, 4, 5):
        C.save(str(tmp_path), step, _state(step), keep=3)
    assert C.latest_step(str(tmp_path)) == 5
    assert sorted(C.all_steps(str(tmp_path))) == [3, 4, 5]


def test_atomic_no_partial_checkpoints(tmp_path):
    C.save(str(tmp_path), 1, _state())
    os.makedirs(tmp_path / "tmp.99")  # a crashed writer's leftover
    assert C.latest_step(str(tmp_path)) == 1
    os.makedirs(tmp_path / "step_50")  # a step without its manifest
    assert C.latest_step(str(tmp_path)) == 1


def test_restore_shape_mismatch_raises(tmp_path):
    C.save(str(tmp_path), 1, _state())
    bad = {"params": {"w": torch.zeros((2, 2)), "b": torch.zeros((4,), dtype=torch.bfloat16)},
           "opt": {"step": torch.tensor(0, dtype=torch.int32)}}
    with pytest.raises(ValueError, match="shape mismatch"):
        C.restore(str(tmp_path), 1, bad)
    with pytest.raises(KeyError):
        C.restore(str(tmp_path), 1, {"params": {"w": torch.zeros((4, 4))}, "other": torch.zeros(1)})


def test_restore_takes_the_template_s_dtype_and_device(tmp_path):
    """The port's elastic restore: leaves matched by key take the template's
    dtype and device (on the card, the template's CUDA device)."""
    s = _state(2.0)
    C.save(str(tmp_path), 4, s)
    template = {"params": {"w": torch.zeros((4, 4), dtype=torch.float64), "b": torch.zeros(4, dtype=torch.float32)},
                "opt": {"step": torch.tensor(0, dtype=torch.int64)}}
    out = C.restore(str(tmp_path), 4, template)
    assert out["params"]["w"].dtype == torch.float64 and float(out["params"]["w"][0, 0]) == 2.0
    assert out["params"]["b"].dtype == torch.float32 and int(out["opt"]["step"]) == 7


def test_async_checkpointer_writes_host_copies(tmp_path):
    ck = C.AsyncCheckpointer(str(tmp_path), keep=2)
    s = _state(1.0)
    for step in (1, 2, 3):
        ck.submit(step, s)
        s["params"]["w"].add_(1.0)  # in place after the submit: the written copy must not see it
    ck.close()
    assert C.latest_step(str(tmp_path)) == 3 and sorted(C.all_steps(str(tmp_path))) == [2, 3]
    out = C.restore(str(tmp_path), 3, tree_map(torch.zeros_like, s))
    assert float(out["params"]["w"][0, 0]) == 3.0


def _fake_step(params, opt, batch):
    return tree_map(lambda p: p + 1, params), opt, {"loss": torch.tensor(1.0)}


def _batches():
    while True:
        yield {}


def test_train_loop_resume(tmp_path):
    params, opt = {"w": torch.zeros(())}, {"m": torch.zeros(())}
    cfg = LoopConfig(total_steps=5, ckpt_dir=str(tmp_path), ckpt_every=2, log_every=100)
    p1, _, _ = train_loop(_fake_step, params, opt, _batches(), cfg, log=lambda s: None)
    assert float(p1["w"]) == 5
    p2, _, _ = train_loop(_fake_step, params, opt, _batches(), cfg, log=lambda s: None)
    assert float(p2["w"]) == 5  # the checkpoint at step 5 exists: no more steps run
    cfg2 = LoopConfig(total_steps=8, ckpt_dir=str(tmp_path), ckpt_every=2, log_every=100)
    p3, _, _ = train_loop(_fake_step, params, opt, _batches(), cfg2, log=lambda s: None)
    assert float(p3["w"]) == 8


def test_preemption_checkpoints_and_exits(tmp_path):
    params, opt = {"w": torch.zeros(())}, {"m": torch.zeros(())}
    guard = PreemptionGuard(install=False)
    calls = {"n": 0}

    def step(p, o, b):
        calls["n"] += 1
        if calls["n"] == 3:
            guard.requested = True  # a SIGTERM mid-run
        return _fake_step(p, o, b)

    cfg = LoopConfig(total_steps=100, ckpt_dir=str(tmp_path), ckpt_every=1000)
    train_loop(step, params, opt, _batches(), cfg, log=lambda s: None, guard=guard)
    assert calls["n"] == 3 and C.latest_step(str(tmp_path)) == 3


def test_straggler_detector():
    d = StragglerDetector(factor=3.0, warmup=2)
    for _ in range(5):
        assert not d.observe(0.1)
    assert d.observe(1.0) and d.anomalies == 1
    assert not d.observe(0.1)


def test_loop_resumes_a_real_train_step_exactly(tmp_path):
    """A real train step: 4 steps straight equal 2 steps, a checkpoint, and
    2 more from it (the loop restarts the batches, so both arms feed the
    same batch every step, as the reference's loop would)."""
    cfg = reduced(get_config("llama3.2-3b"), d_model=32, n_layers=2, vocab=64)
    batch = {"tokens": torch.arange(64).reshape(4, 16) % 64, "labels": (torch.arange(64).reshape(4, 16) + 1) % 64}

    def batches():
        while True:
            yield batch

    step = make_train_step(cfg, lr=1e-2)
    p0 = init_params(cfg, seed=0, device="cpu")
    straight, _, _ = train_loop(step, tree_map(torch.clone, p0), adamw_init(p0), batches(),
                                LoopConfig(total_steps=4), log=lambda s: None)
    d = str(tmp_path)
    train_loop(step, tree_map(torch.clone, p0), adamw_init(p0), batches(),
               LoopConfig(total_steps=2, ckpt_dir=d, ckpt_every=1), log=lambda s: None)
    resumed, opt, _ = train_loop(step, tree_map(torch.clone, p0), adamw_init(p0), batches(),
                                 LoopConfig(total_steps=4, ckpt_dir=d, ckpt_every=1), log=lambda s: None)
    assert int(opt.step) == 4
    for a, b in zip(tree_leaves(straight), tree_leaves(resumed)):
        assert torch.equal(a, b)


def test_train_cli_runs_checkpoints_and_resumes(tmp_path):
    """``python -m repro_torch.launch.train --device cpu``: 4 reduced steps
    with a checkpoint dir, then a rerun to 6 resumes from step 4."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--batch", "4", "--seq", "16",
           "--log-every", "1", "--ckpt-dir", str(tmp_path)]
    first = subprocess.run(cmd + ["--steps", "4"], capture_output=True, text=True, env=env, timeout=300)
    assert first.returncode == 0, first.stderr
    assert [line.split()[1] for line in first.stdout.splitlines() if line.startswith("step")] == ["0", "1", "2", "3"]
    assert C.latest_step(str(tmp_path)) == 4
    second = subprocess.run(cmd + ["--steps", "6"], capture_output=True, text=True, env=env, timeout=300)
    assert second.returncode == 0, second.stderr
    lines = second.stdout.splitlines()
    assert lines[0] == "[restore] resumed from step 4"
    assert [line.split()[1] for line in lines if line.startswith("step")] == ["4", "5"]
    assert C.latest_step(str(tmp_path)) == 6
