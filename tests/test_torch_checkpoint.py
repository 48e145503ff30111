"""Checkpoints cross between the JAX package and the port both ways: the
same ``state.pkl`` / ``config.json`` layout, optax's Adam state mapped onto
``torch.optim.Adam``'s, and the next Adam step equal on both sides.

Small sizes: 16 px, hidden 32, batch 8. Tolerances, float32 on the CPU:
params after the next Adam step atol 1e-6, with both sides fed the same
gradients (a step is about lr·m/sqrt(v), so each side's own float noise in
a near-zero gradient would show); served latents atol 1e-5.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp

from cdgvae_tpu.api import LoadedModel as JLoadedModel
from cdgvae_tpu.data import pendulum as jdata
from cdgvae_tpu.factory import pendulum_B
from cdgvae_tpu.models import vae as jvae
from cdgvae_tpu.ops.causal import CausalGraph as JGraph
from cdgvae_tpu.ops.renderer import render as jax_render
from cdgvae_tpu.train import scanned as jscanned
from cdgvae_tpu.utils import checkpoint as jck
from cdgvae_torch.api import LoadedModel
from cdgvae_torch.models import vae as tvae
from cdgvae_torch.ops.causal import CausalGraph as TGraph
from cdgvae_torch.train import steps as tsteps
from cdgvae_torch.utils import checkpoint as tck
from cdgvae_torch.utils.interop import (export_opt_state, export_params,
                                        load_jax_opt_state, load_jax_params)

ROOT = Path(__file__).resolve().parent.parent
SIZE, HIDDEN, BATCH, LR = 16, 32, 8, 1e-3


def _masks():
    masks = np.zeros((3, SIZE, SIZE, 3), np.float32)
    for i, (r0, r1) in enumerate([(0, 5), (5, 13), (13, SIZE)]):
        masks[i, r0:r1] = 1.0
    return masks


def _models():
    B = pendulum_B(4)
    jm = jvae.CDGVAE(JGraph(B), _masks(), [1, 1, 2], image_size=SIZE,
                     hidden=HIDDEN)
    tm = tvae.CDGVAE(TGraph(B), _masks(), [1, 1, 2], image_size=SIZE,
                     hidden=HIDDEN)
    return jm, tm


def _batches(n_steps):
    factors, _ = jdata.sample_factors_real(seed=4, n=BATCH * n_steps)
    y = jdata.normalize_labels(factors)[0].astype(np.float32)
    x = np.asarray(jax_render(jnp.asarray(factors[:, :4], jnp.float32),
                              size=SIZE))
    return [(x[i * BATCH:(i + 1) * BATCH], y[i * BATCH:(i + 1) * BATCH])
            for i in range(n_steps)]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _grad_fn(jm):
    """Jitted ``grads(params, (x, y), key)`` of the supervised loss."""
    loss_fn = jscanned.make_supervised_loss_fn(jm, 0.1, 5.0)
    grad = jax.jit(jax.grad(lambda p, x, y, k: loss_fn(p, x, y, k)[0]))
    return lambda params, batch, key: grad(params, *map(jnp.asarray, batch),
                                           key)


def _torch_step_with(tm, optimizer, grads):
    """One Adam step of the port fed the JAX gradient tree."""
    flat = _flat(grads)
    for name, p in tm.named_parameters():
        p.grad = torch.tensor(flat[name])
    optimizer.step()


def _assert_params_equal(got_tree, want_tree, atol):
    got, want = _flat(got_tree), _flat(want_tree)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=atol,
                                   err_msg=name)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    jm, tm = _models()
    batches = _batches(4)
    grads = _grad_fn(jm)
    opt = optax.adam(LR)
    params = jm.init(jax.random.key(0))
    state = opt.init(params)
    for i in range(3):
        g = grads(params, batches[i], jax.random.key(i))
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
    jck.save_checkpoint(str(tmp_path / "ck"), params, opt_state=state,
                        step=3, config={"model": "CDGVAE"})

    ck = tck.load_checkpoint(str(tmp_path / "ck"))
    assert ck["step"] == 3 and int(ck["opt_state"][0].count) == 3
    optimizer = tsteps.make_optimizer(tm, LR)
    load_jax_params(tm, ck["params"])
    load_jax_opt_state(optimizer, tm, ck["opt_state"])
    for st in optimizer.state.values():
        assert float(st["step"]) == 3.0

    g = grads(params, batches[3], jax.random.key(3))
    updates, _ = opt.update(g, state, params)
    want = optax.apply_updates(params, updates)
    _torch_step_with(tm, optimizer, g)
    _assert_params_equal(export_params(tm), want, atol=1e-6)


def test_port_checkpoint_resumes_and_serves_in_jax(tmp_path):
    jm, tm = _models()
    batches = _batches(4)
    grads = _grad_fn(jm)
    params0 = jax.tree.map(np.asarray, jm.init(jax.random.key(1)))
    load_jax_params(tm, params0)
    optimizer = tsteps.make_optimizer(tm, LR)
    # before a step the exported state is optax's init
    init = export_opt_state(optimizer, tm)
    assert int(init[0].count) == 0
    for leaf in _flat(init[0].mu).values():
        assert not leaf.any()
    p = jax.tree.map(jnp.asarray, params0)
    for i in range(3):
        _torch_step_with(tm, optimizer,
                         grads(p, batches[i], jax.random.key(i)))
        p = jax.tree.map(jnp.asarray, export_params(tm))
    ckpt = str(tmp_path / "ck")
    config = dict(model="CDGVAE", node=4, scm="linear", flow_num=1,
                  inverse_loop=100, factor=[1, 1, 2], image_size=SIZE,
                  adjacency_scaling=True, spurious=False)
    tck.save_checkpoint(ckpt, export_params(tm),
                        opt_state=export_opt_state(optimizer, tm), step=3,
                        config=config)

    ck = jck.load_checkpoint(ckpt)
    assert type(ck["opt_state"][0]) is optax.ScaleByAdamState
    assert type(ck["opt_state"][1]) is optax.EmptyState
    assert ck["opt_state"][0].count.dtype == np.int32
    assert int(ck["opt_state"][0].count) == 3 and ck["step"] == 3
    assert ck["config"] == config and ck["extras"] is None
    params = jax.tree.map(jnp.asarray, ck["params"])
    g = grads(params, batches[3], jax.random.key(3))
    updates, _ = optax.adam(LR).update(g, ck["opt_state"], params)
    want = optax.apply_updates(params, updates)
    _torch_step_with(tm, optimizer, g)
    _assert_params_equal(export_params(tm), want, atol=1e-6)


def test_jax_loaded_model_serves_a_port_checkpoint(tmp_path):
    config = dict(model="CDGVAE", node=4, scm="linear", flow_num=1,
                  inverse_loop=100, factor=[1, 1, 2], image_size=SIZE,
                  adjacency_scaling=True, spurious=False, device="cpu")
    from cdgvae_torch.factory import build_pendulum_model
    model, _ = build_pendulum_model(config, device="cpu", seed=3)
    ckpt = str(tmp_path / "ck")
    tck.save_checkpoint(ckpt, export_params(model),
                        opt_state=export_opt_state(
                            tsteps.make_optimizer(model, LR), model),
                        step=1, config=config)
    x = np.tanh(np.random.default_rng(0).normal(
        size=(4, SIZE, SIZE, 3))).astype(np.float32)
    np.testing.assert_allclose(
        JLoadedModel.load(ckpt).encode(x),
        LoadedModel.load(ckpt, device="cpu").encode(x), rtol=0, atol=1e-5)


_BLOCKED_LOAD = """
import sys
sys.modules["optax"] = None
sys.modules["jax"] = None
from cdgvae_torch.utils.checkpoint import load_checkpoint
ck = load_checkpoint(sys.argv[1])
adam = ck["opt_state"][0]
print(int(adam.count), ck["step"], sorted(adam.mu), ck["config"]["model"])
"""


def test_load_needs_neither_optax_nor_jax(tmp_path):
    params = {"encoder": {"w": np.ones((2, 3), np.float32)}}
    opt = optax.adam(LR)
    state = opt.init(params)
    state = (state[0]._replace(count=jnp.asarray(5, jnp.int32)), state[1])
    jck.save_checkpoint(str(tmp_path / "ck"), params, opt_state=state,
                        step=7, config={"model": "CDGVAE"})
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_LOAD,
                           str(tmp_path / "ck")], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["5", "7", "['encoder']", "CDGVAE"]


def test_checkpoint_write_is_atomic(tmp_path, monkeypatch):
    """A crash mid-write keeps the previous checkpoint."""
    ckpt = str(tmp_path / "at")
    tck.save_checkpoint(ckpt, {"w": np.ones(3)}, config={"v": 1})

    class Boom(Exception):
        pass

    def exploding_dump(self, obj):
        self.write(b"partial garbage")
        raise Boom()

    monkeypatch.setattr(tck._Pickler, "dump", exploding_dump)
    with pytest.raises(Boom):
        tck.save_checkpoint(ckpt, {"w": np.zeros(3)}, config={"v": 2})
    payload = tck.load_checkpoint(ckpt)
    np.testing.assert_array_equal(payload["params"]["w"], np.ones(3))
    assert payload["config"] == {"v": 1}
    assert jck.load_checkpoint(ckpt)["config"] == {"v": 1}


def test_config_json_bytes_equal_jax(tmp_path):
    config = {"model": "CDGVAE", "factor": [1, 1, 2], "lr": 0.001,
              "beta": np.float32(0.1), "node": np.int64(4),
              "bounds": (0, 20), "arr": np.arange(3), "nested": {"b": True,
                                                              "a": None}}
    jck.save_checkpoint(str(tmp_path / "j"), {"w": np.ones(1)},
                        config=config)
    tck.save_checkpoint(str(tmp_path / "t"), {"w": np.ones(1)},
                        config=config)
    j = (tmp_path / "j" / "config.json").read_bytes()
    assert (tmp_path / "t" / "config.json").read_bytes() == j
    assert json.loads(j)["node"] == 4
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j"))
