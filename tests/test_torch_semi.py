"""The port's semi-supervised training against the JAX package: one step
from shared params, images, labels and noise; the eager epoch's batch
indices; the two-stream epoch runner's semantics; the online trainer's
labeled subsample.

Small sizes: 16 px, hidden 32, an unlabeled batch of 8 and a labeled batch
of 4, with an exact row partition of the image as decoder masks so the
band-sliced decoder of the main path runs. Tolerances, float32 on the
CPU: metrics rtol 1e-5 / atol 1e-6; gradients rtol 1e-4 / atol 1e-6 *
max|g|; Adam fed the same gradients atol 1e-7. The batch indices are equal
exactly.
"""
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
from cdgvae_tpu.train import steps as jsteps
from cdgvae_torch.cli import common as tcommon
from cdgvae_torch.models import vae as tvae
from cdgvae_torch.ops.causal import CausalGraph as TGraph
from cdgvae_torch.train import loop as tloop
from cdgvae_torch.train import online as tonline
from cdgvae_torch.train import scanned as tscanned
from cdgvae_torch.train import steps as tsteps
from cdgvae_torch.utils.interop import export_params, load_jax_params

SIZE, HIDDEN, BATCH, BATCH_L, NODE = 16, 32, 8, 4, 4
BETA, LAM, LR = 0.1, 5.0, 1e-3


def _row_masks():
    masks = np.zeros((3, SIZE, SIZE, 3), np.float32)
    for i, (r0, r1) in enumerate([(0, 5), (5, 13), (13, SIZE)]):
        masks[i, r0:r1] = 1.0
    return masks


def _models(params=None):
    """(jax model, its params as numpy, port model holding them)."""
    B = jax_pendulum_B(NODE)
    jm = jvae.CDGVAE(JGraph(B, scm="nonlinear"), _row_masks(), [1, 1, 2],
                     image_size=SIZE, hidden=HIDDEN)
    tm = tvae.CDGVAE(TGraph(B, scm="nonlinear"), _row_masks(), [1, 1, 2],
                     image_size=SIZE, hidden=HIDDEN)
    if params is None:
        params = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    load_jax_params(tm, params)
    assert tm._bands is not None
    return jm, params, tm


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_semi_step_matches_jax():
    jm, params, tm = _models()
    factors, _ = jdata.sample_factors_real(seed=2, n=BATCH + BATCH_L)
    y = jdata.normalize_labels(factors)[0].astype(np.float32)
    x = np.asarray(jax_render(jnp.asarray(factors[:, :4], jnp.float32),
                              size=SIZE))
    batch = (x[:BATCH].copy(), x[BATCH:].copy(), y[BATCH:])
    key = jax.random.key(11)

    opt = optax.adam(LR)
    p_j = jax.tree.map(jnp.asarray, params)
    step_j = jsteps.make_semi_step(jm, opt, BETA, LAM, jit=False)
    want_params, _, m_j = step_j(p_j, opt.init(p_j),
                                 *map(jnp.asarray, batch), key)
    g_j = _flat(jax.grad(lambda p: jsteps.make_semi_loss_fn(jm, BETA, LAM)(
        p, *map(jnp.asarray, batch), key)[0])(p_j))

    step_t = tsteps.make_semi_step(tm, tsteps.make_optimizer(tm, LR), BETA,
                                   LAM)
    noise = torch.tensor(np.asarray(jax.random.normal(key, (BATCH, NODE))))
    m_t = step_t(*map(torch.from_numpy, batch), noise=noise)
    assert list(m_t) == list(jsteps._metrics(0.0, 0.0, 0.0, 0.0,
                                             jnp.zeros((2, NODE)), NODE))
    for k in m_j:
        np.testing.assert_allclose(m_t[k].item(), float(m_j[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for name, p in tm.named_parameters():  # the step leaves its grads
        atol = 1e-6 * float(np.abs(g_j[name]).max())
        np.testing.assert_allclose(p.grad.numpy(), g_j[name], rtol=1e-4,
                                   atol=atol, err_msg=name)

    # Adam on the same gradients (a first step is about ±lr·sign(g))
    _, _, fresh = _models(params)
    for name, p in fresh.named_parameters():
        p.grad = torch.tensor(g_j[name])
    tsteps.make_optimizer(fresh, LR).step()
    got, want = _flat(export_params(fresh)), _flat(want_params)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-7,
                                   err_msg=name)


def _ids(n, base=0):
    """Items whose every value is ``base`` + their index."""
    return np.arange(base, base + n, dtype=np.float32)[:, None].repeat(3, 1)


def test_eager_semi_indices_match_jax():
    """37 unlabeled rows at batch 8 (the last batch short), 11 labeled
    rows at batch 4: the labeled stream runs out after 3 batches (the last
    short) and reshuffles. Two epochs on one numpy shuffle generator."""
    n_u, n_l, bs, bs_l = 37, 11, 8, 4
    x_u, x_l, y_l = _ids(n_u), _ids(n_l, 100), _ids(n_l, 200)
    seen_j, seen_t = [], []

    def step_j(state, xu, xl, yl, rng):
        seen_j.append((np.asarray(xu)[:, 0].tolist(),
                       np.asarray(xl)[:, 0].tolist(),
                       np.asarray(yl)[:, 0].tolist()))
        return state, {"loss": jnp.float32(0.0)}

    def step_t(xu, xl, yl, generator=None):
        seen_t.append((xu[:, 0].tolist(), xl[:, 0].tolist(),
                       yl[:, 0].tolist()))
        return {"loss": torch.tensor(0.0)}

    rng_j, rng_t = np.random.default_rng(5), np.random.default_rng(5)
    for epoch in range(2):
        jloop.train_epoch_semi(step_j, (0,), x_u, x_l, y_l, bs, bs_l,
                               jax.random.key(0), epoch, rng_j)
        tloop.train_epoch_semi(step_t, *map(torch.from_numpy,
                                            (x_u, x_l, y_l)),
                               bs, bs_l, None, rng_t)
    assert seen_t == seen_j
    assert [len(u) for u, _, _ in seen_t[:5]] == [8, 8, 8, 8, 5]
    assert [len(l) for _, l, _ in seen_t[:5]] == [4, 4, 3, 4, 4]
    assert all((np.array(y) - np.array(l) == 100).all()
               for _, l, y in seen_t)


def test_scanned_semi_semantics():
    """37 unlabeled rows at batch 8: 4 full batches, the remainder
    dropped; 11 labeled rows at batch 4: 16 labeled draws from
    ceil(16 / 11) = 2 concatenated permutations, every batch full."""
    n_u, n_l, bs, bs_l = 37, 11, 8, 4
    x_u = torch.from_numpy(_ids(n_u)).reshape(n_u, 1, 1, 3)
    x_l = torch.from_numpy(_ids(n_l, 100)).reshape(n_l, 1, 1, 3)
    y_l = torch.from_numpy(_ids(n_l, 200))
    seen = []

    def step(xu, xl, yl, generator=None):
        assert xu.shape == (bs, 1, 1, 3) and xl.shape == (bs_l, 1, 1, 3)
        assert torch.equal(yl[:, 0] - xl[:, 0, 0, 0], torch.full((bs_l,),
                                                                 100.0))
        seen.append((xu[:, 0, 0, 0].long().tolist(),
                     (xl[:, 0, 0, 0] - 100).long().tolist()))
        return {"loss": xu.mean()}

    run = tscanned.make_scanned_epochs_semi(step, bs, bs_l)
    metrics = run(x_u, x_l, y_l, torch.Generator().manual_seed(0))
    assert len(seen) == n_u // bs
    u = [i for b, _ in seen for i in b]
    assert len(set(u)) == 32 and max(u) < n_u
    assert metrics["loss"] == pytest.approx(np.mean(u), rel=1e-6)
    lab = [i for _, b in seen for i in b]
    assert sorted(lab[:n_l]) == list(range(n_l))      # one permutation
    assert len(set(lab[n_l:])) == 16 - n_l            # the next one, cut
    # the generator draws the unlabeled permutation, then the labeled ones
    g = torch.Generator().manual_seed(0)
    assert tscanned.epoch_batches(n_u, bs, g).tolist() == [b for b, _ in seen]
    assert tscanned.labeled_batches(n_l, 4, bs_l, g).tolist() == \
        [b for _, b in seen]

    for bad in (tscanned.make_scanned_epochs_semi(step, 64, bs_l),
                tscanned.make_scanned_epochs_semi(step, bs, 16)):
        with pytest.raises(ValueError, match="streams too small"):
            bad(x_u, x_l, y_l, torch.Generator())


def _recording_loss():
    """A semi loss over one parameter that records each step's labeled
    ids."""
    w = torch.zeros(1, requires_grad=True)
    seen = []

    def loss_fn(x_u, x_l, y_l, generator=None):
        seen.append(x_l[:, 0].long().tolist())
        loss = (w * x_l.mean()).sum()
        return loss, {"loss": loss}

    return loss_fn, torch.optim.SGD([w], lr=0.0), seen


def test_online_semi_subsamples_without_replacement():
    n_l = 10
    x_l, y_l = torch.arange(n_l, dtype=torch.float32)[:, None], \
        torch.zeros(n_l, 5)

    def sample_batch(generator, index_offset=0):
        return torch.zeros(4, 1), torch.zeros(4, 5)

    loss_fn, opt, seen = _recording_loss()
    run = tonline.make_online_run_from_loss(
        loss_fn, opt, sample_batch, 6, seed=3, device="cpu",
        labeled=(x_l, y_l), batch_size_l=4)
    assert run(0)["loss"].shape == (6,)
    assert all(len(s) == 4 == len(set(s)) and max(s) < n_l for s in seen)
    assert len({tuple(s) for s in seen}) > 1
    first = list(seen)
    run(0)  # the same steps draw the same rows
    assert seen[6:] == first
    with pytest.raises(ValueError, match="labeled batch of 11"):
        tonline.make_online_run_from_loss(loss_fn, opt, sample_batch, 1,
                                          seed=0, device="cpu",
                                          labeled=(x_l, y_l),
                                          batch_size_l=11)

    # the CLI's online runner clamps batch_sizeL to the labeled rows: every step
    # then takes all 10, each once
    seen.clear()
    config = dict(batch_size=4, n_samples=16, seed=0, epochs=1,
                  batch_sizeL=32)
    hist = tcommon.run_online_training(
        config, loss_fn=loss_fn, optimizer=opt, device="cpu", start_epoch=0,
        on_epoch=lambda e, m: None,
        sample_batch_builder=lambda bs: sample_batch, labeled=(x_l, y_l))
    assert len(hist) == 1 and len(seen) == 12 // 4
    assert all(sorted(s) == list(range(n_l)) for s in seen)
