"""The port's training slice against the JAX package: render -> loss ->
grads -> Adam from shared factors, params and noise; a short run; the epoch
runner; the CLI.

Small sizes: 16 px, hidden 32, batch 8, with an exact row partition of the
image as decoder masks so the band-sliced decoder of the main path runs.
Tolerances, float32 on the CPU: loss and metrics rtol 1e-5 / atol 1e-6;
gradients rtol 1e-4 / atol 1e-6 * max|g|; Adam fed the same gradients
atol 1e-7; the losses of a 5-step run rtol 1e-4 (the two runs apply
updates computed from their own gradients).
"""
import math
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

from cdgvae_tpu.data import pendulum as jdata
from cdgvae_tpu.factory import pendulum_B as jax_pendulum_B
from cdgvae_tpu.models import vae as jvae
from cdgvae_tpu.ops.causal import CausalGraph as JGraph
from cdgvae_tpu.ops.renderer import render as jax_render
from cdgvae_tpu.train import loop as jloop
from cdgvae_tpu.train import scanned as jscanned
from cdgvae_tpu.train import steps as jsteps
from cdgvae_torch.models import vae as tvae
from cdgvae_torch.ops.causal import CausalGraph as TGraph
from cdgvae_torch.ops.renderer import render
from cdgvae_torch.train import loop as tloop
from cdgvae_torch.train import scanned as tscanned
from cdgvae_torch.train import steps as tsteps
from cdgvae_torch.utils.interop import export_params, load_jax_params

ROOT = Path(__file__).resolve().parent.parent
SIZE, HIDDEN, BATCH, NODE, FACTOR = 16, 32, 8, 4, [1, 1, 2]
BETA, LAM, LR = 0.1, 5.0, 1e-3


def _row_masks():
    masks = np.zeros((3, SIZE, SIZE, 3), np.float32)
    for i, (r0, r1) in enumerate([(0, 5), (5, 13), (13, SIZE)]):
        masks[i, r0:r1] = 1.0
    return masks


def _pair():
    B = jax_pendulum_B(NODE)
    jm = jvae.CDGVAE(JGraph(B), _row_masks(), FACTOR, image_size=SIZE,
                     hidden=HIDDEN)
    tm = tvae.CDGVAE(TGraph(B), _row_masks(), FACTOR, image_size=SIZE,
                     hidden=HIDDEN)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    load_jax_params(tm, params)
    assert tm._bands is not None
    return jm, params, tm


def _data(n):
    factors, _ = jdata.sample_factors_real(seed=2, n=n)
    labels = jdata.normalize_labels(factors)[0].astype(np.float32)
    return factors[:, :4].astype(np.float32), labels


def _noise(key):
    return np.asarray(jax.random.normal(key, (BATCH, NODE), jnp.float32))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_one_step_matches_jax():
    jm, params, tm = _pair()
    f, y = _data(BATCH)
    key = jax.random.key(11)

    x_j = jax_render(jnp.asarray(f), size=SIZE)
    loss_fn_j = jscanned.make_supervised_loss_fn(jm, BETA, LAM)
    (loss_j, m_j), g_j = jax.value_and_grad(loss_fn_j, has_aux=True)(
        jax.tree.map(jnp.asarray, params), x_j, jnp.asarray(y), key)

    x_t = render(torch.from_numpy(f), SIZE)
    loss_fn_t = tscanned.make_supervised_loss_fn(tm, BETA, LAM)
    loss_t, m_t = loss_fn_t(x_t, torch.from_numpy(y),
                            noise=torch.tensor(_noise(key)))
    loss_t.backward()

    # key order as the reference's log dict (jax.grad returns aux dicts
    # with sorted keys, so read the order from _metrics itself)
    assert list(m_t) == list(jsteps._metrics(0.0, 0.0, 0.0, 0.0,
                                             jnp.zeros((2, NODE)), NODE))
    for k in m_j:
        np.testing.assert_allclose(m_t[k].item(), float(m_j[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)

    g_flat = _flat(g_j)
    named = dict(tm.named_parameters())
    assert set(named) == set(g_flat)
    for name, p in named.items():
        atol = 1e-6 * float(np.abs(g_flat[name]).max())
        np.testing.assert_allclose(p.grad.numpy(), g_flat[name], rtol=1e-4,
                                   atol=atol, err_msg=name)

    # Adam on the SAME gradients: a first step is about ±lr·sign(g), so
    # float noise in a near-zero gradient would flip it if each side used
    # its own
    opt = optax.adam(LR)
    p_j = jax.tree.map(jnp.asarray, params)
    updates, _ = opt.update(g_j, opt.init(p_j), p_j)
    want = _flat(optax.apply_updates(p_j, updates))
    for name, p in named.items():
        p.grad = torch.tensor(g_flat[name])
    tsteps.make_optimizer(tm, LR).step()
    got = _flat(export_params(tm))
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-7,
                                   err_msg=name)


def test_five_steps_track_jax():
    jm, params, tm = _pair()
    f, y = _data(40)
    x = np.asarray(jax_render(jnp.asarray(f), size=SIZE))
    order = np.random.default_rng(0).permutation(40)
    keys = jax.random.split(jax.random.key(3), 5)

    opt = optax.adam(LR)
    step_j = jax.jit(jsteps.make_train_step(jm, opt, BETA, LAM, jit=False))
    p_j = jax.tree.map(jnp.asarray, params)
    s_j = opt.init(p_j)
    step_t = tsteps.make_train_step(tm, tsteps.make_optimizer(tm, LR), BETA,
                                    LAM)
    losses_j, losses_t = [], []
    for i in range(5):
        idx = order[i * BATCH:(i + 1) * BATCH]
        p_j, s_j, m_j = step_j(p_j, s_j, jnp.asarray(x[idx]),
                               jnp.asarray(y[idx]), keys[i])
        m_t = step_t(torch.from_numpy(x[idx]), torch.from_numpy(y[idx]),
                     noise=torch.tensor(_noise(keys[i])))
        losses_j.append(float(m_j["loss"]))
        losses_t.append(m_t["loss"].item())
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    assert losses_t[-1] < losses_t[0]


def _indexed_data(n):
    """Items whose every value is their own index, to read batches back."""
    x = torch.arange(n, dtype=torch.float32)[:, None, None, None]
    return x.expand(n, 2, 2, 3).contiguous(), \
        torch.arange(n, dtype=torch.float32)[:, None].repeat(1, 5)


def test_epoch_runner_semantics():
    n, bs = 37, 8
    x, y = _indexed_data(n)
    seen = []

    def step(xi, yi, generator=None):
        ids = xi[:, 0, 0, 0].long()
        assert xi.shape[1:] == (2, 2, 3)
        assert torch.equal(yi[:, 0].long(), ids)
        seen.append(ids.tolist())
        return {"loss": xi.mean(), "count": torch.tensor(float(len(seen)))}

    run = tscanned.make_epoch_runner(step, bs)
    g = torch.Generator().manual_seed(0)
    hist = [run(x, y, g), run(x, y, g)]
    steps = n // bs
    assert len(seen) == 2 * steps
    for e in range(2):
        epoch = seen[e * steps:(e + 1) * steps]
        ids = [i for batch in epoch for i in batch]
        assert all(len(b) == bs for b in epoch)
        assert len(set(ids)) == steps * bs and max(ids) < n  # remainder dropped
        assert hist[e]["loss"] == pytest.approx(
            np.mean([np.mean(b) for b in epoch]), rel=1e-6)
        assert hist[e]["count"] == pytest.approx(e * steps + (steps + 1) / 2)
    assert seen[:steps] != seen[steps:]  # a new permutation each epoch
    again = tscanned.epoch_batches(n, bs, torch.Generator().manual_seed(0))
    assert again.tolist() == seen[:steps]

    with pytest.raises(ValueError, match="batch_size"):
        tscanned.make_epoch_runner(step, 64)(x, y, torch.Generator())

    # run_epochs clamps the batch size to the dataset: one full step/epoch
    seen.clear()
    lines = []
    hist = tloop.run_epochs(step, x, y, seed=0, epochs=2, batch_size=64,
                            on_epoch=lambda e, m: lines.append(e))
    assert lines == [0, 1] and len(hist) == 2
    assert [len(b) for b in seen] == [n, n]


def test_format_epoch_matches_jax():
    m = {"loss": 1234.56789, "recon": 1.0, "KL": 0.00004, "alignment": 2.5,
         "posterior_variance1": 0.1}
    for epoch in (0, 9, 120):
        assert tloop.format_epoch(epoch, m) == jloop.format_epoch(epoch, m)


def _cli(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-m", "cdgvae_torch.cli.main",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_cli_trains_on_cpu(tmp_path):
    proc = _cli("--device", "cpu", "--image_size", "16", "--n_samples", "96",
                "--epochs", "2", "--assets_dir", str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("[epoch")]
    assert [ln[:11] for ln in lines] == ["[epoch 001]", "[epoch 002]"]
    for ln in lines:
        loss = float(ln.split("loss: ")[1].split(",")[0])
        assert math.isfinite(loss)


def test_cli_without_gpu_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _cli("--image_size", "16", "--n_samples", "96", "--epochs", "1")
    assert proc.returncode != 0
    assert "[epoch" not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_cli_rejects_what_is_not_ported(tmp_path):
    # --dp is ported: on the GPU, more ranks than visible GPUs (2 where
    # there is none) are refused with the device count, and no rank starts
    n = max(2, torch.cuda.device_count() + 1)
    proc = _cli("--dp", str(n), "--batch_size", str(8 * n))
    assert proc.returncode != 0 and "[epoch" not in proc.stdout
    assert "[dp] training" not in proc.stdout
    assert f"{n}-device mesh" in proc.stderr
    # --data_dir is ported: a tree written by cli.generate_data trains
    tree = tmp_path / "tree"
    gen = subprocess.run(
        [sys.executable, "-m", "cdgvae_torch.cli.generate_data", "--device",
         "cpu", "--n", "48", "--image_size", "16", "--out", str(tree)],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert gen.returncode == 0, gen.stderr
    proc = _cli("--device", "cpu", "--image_size", "16", "--batch_size", "8",
                "--epochs", "1", "--data_dir", str(tree), "--assets_dir",
                str(tmp_path / "run"))
    assert proc.returncode == 0, proc.stderr
    assert "ROADMAP" not in proc.stderr and "[epoch 001]" in proc.stdout
