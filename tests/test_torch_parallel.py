"""The port's data parallelism against the JAX package's mesh trainers.

The port runs one process a rank (gloo on the CPU here); the JAX package
runs its mesh over the conftest's 8 virtual CPU devices. Two launches, at
world sizes 2 and 4, replay the same inputs on every rank
(``cdgvae_torch.parallel.replay``):

(a) an eager step over one global batch, each rank its slice of the batch
    and of the JAX global noise, against ``train.steps.make_train_step(...,
    mesh=make_mesh(D))``;
(b) a one-step sharded epoch whose shard is one local batch, each rank fed
    the permutation and noise (and InfoMax's roll) that the reference's
    folded keys give its device, against ``make_sharded_scanned_epochs_
    from_loss`` (supervised, InfoMax with ``"roll"``) and ``make_sharded_
    scanned_epochs_semi_from_loss``;
(c) the sharded online trainer's draws: the row offset each rank draws at,
    and the DGP at it against ``sample_factors_device``;
(d) the parameters after 2 sharded epochs at world 2, equal on every rank;
(e) the global-batch BatchNorm of the eager CelebA step (the JAX GSPMD
    step's statistics): each rank's slice against the whole batch.

``dryrun_multichip(2, "cpu")`` runs every data-parallel path once.

A world-1 mesh run in this process equals the one-device run bit for bit.

Small sizes: 16 px, hidden 32, global batch 8. Tolerances, float32 on the
CPU, as the one-device step tests: metrics rtol 1e-5 / atol 1e-6;
gradients rtol 1e-4 / atol 1e-6 * max|g|; Adam fed the port's gradients
atol 1e-7; the online DGP's angles exactly, its length and position 1e-5
(XLA and torch round sin/cos one ulp apart).
"""
import math
import pickle

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from cdgvae_tpu.data import pendulum as jdata
from cdgvae_tpu.factory import pendulum_B as jax_pendulum_B
from cdgvae_tpu.models import classifier as jclf
from cdgvae_tpu.models import vae as jvae
from cdgvae_tpu.ops.causal import CausalGraph as JGraph
from cdgvae_tpu.ops.renderer import render as jax_render
from cdgvae_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cdgvae_tpu.train import online as jonline
from cdgvae_tpu.train import scanned as jscanned
from cdgvae_tpu.train import steps as jsteps
from cdgvae_torch import nn as tnn
from cdgvae_torch.models import vae as tvae
from cdgvae_torch.ops.causal import CausalGraph as TGraph
from cdgvae_torch.parallel import launch, replicate
from cdgvae_torch.parallel.dryrun import dryrun_multichip
from cdgvae_torch.parallel.replay import run_cases
from cdgvae_torch.train import loop as tloop
from cdgvae_torch.train import steps as tsteps
from cdgvae_torch.utils.interop import export_params, load_jax_params

SIZE, HIDDEN, BATCH, NODE, FACTOR = 16, 32, 8, 4, [1, 1, 2]
BETA, LAM, GAMMA, LR, LR_D = 0.1, 5.0, 1.0, 1e-3, 1e-4
SEED = 5  # the port's run seed; the reference's step keys are below


def _row_masks():
    masks = np.zeros((3, SIZE, SIZE, 3), np.float32)
    for i, (r0, r1) in enumerate([(0, 5), (5, 13), (13, SIZE)]):
        masks[i, r0:r1] = 1.0
    return masks


def _spec(model: str):
    B = jax_pendulum_B(NODE)
    if model == "CDGVAE":
        jm = jvae.CDGVAE(JGraph(B), _row_masks(), FACTOR, image_size=SIZE,
                         hidden=HIDDEN)
    else:
        jm = jvae.VAE(JGraph(B), image_size=SIZE, hidden=HIDDEN)
    spec = dict(model=model, B=np.asarray(B), masks=_row_masks(),
                factor=FACTOR, size=SIZE, hidden=HIDDEN,
                params=jax.tree.map(np.asarray, jm.init(jax.random.key(0))))
    jd = None
    if model == "VAE":
        jd = jclf.Discriminator(NODE, image_size=SIZE, hidden=HIDDEN)
        spec["d_params"] = jax.tree.map(np.asarray,
                                        jd.init(jax.random.key(1)))
    return spec, jm, jd


def _data(n, seed=2):
    factors, _ = jdata.sample_factors_real(seed=seed, n=n)
    y = jdata.normalize_labels(factors)[0].astype(np.float32)
    x = np.array(jax_render(jnp.asarray(factors[:, :4], jnp.float32),
                            size=SIZE))
    return x, y


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _unflat(flat):
    """{"a.b": v} -> {"a": {"b": v}}, the leaves as jax arrays."""
    out = {}
    for k, v in flat.items():
        *path, leaf = k.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(v)
    return out


def _tree(spec, jd):
    p = jax.tree.map(jnp.asarray, spec["params"])
    return (p, jax.tree.map(jnp.asarray, spec["d_params"])) if jd else p


def _case(kind, spec, **kw):
    return dict(kind=kind, spec=spec, beta=BETA, lam=LAM, gamma=GAMMA,
                lr=LR, lr_d=LR_D, seed=SEED, **kw)


def _eager_case(d):
    """(a): the global batch in the order of the shuffle's permutation,
    the JAX step's global noise, and the JAX mesh step's metrics and the
    global-batch gradients."""
    spec, jm, _ = _spec("CDGVAE")
    x, y = _data(BATCH)
    shuffle_seed = 3
    perm = np.random.default_rng(shuffle_seed).permutation(BATCH)
    xb, yb = x[perm], y[perm]
    key = jax.random.key(11)
    noise = np.asarray(jax.random.normal(key, (BATCH, NODE), jnp.float32))
    opt = optax.adam(LR)
    step = jsteps.make_train_step(jm, opt, BETA, LAM,
                                  mesh=jax_make_mesh(d), donate=False)
    p = _tree(spec, None)
    _, _, m_j = step(p, opt.init(p), xb, yb, key)
    loss_fn = jscanned.make_supervised_loss_fn(jm, BETA, LAM)
    (_, _), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        p, jnp.asarray(xb), jnp.asarray(yb), key)
    want = dict(metrics={k: float(v) for k, v in m_j.items()},
                grads={f"model.{k}": v for k, v in _flat(g).items()})
    case = _case("eager", spec, x=x, y=y, batch_size=BATCH,
                 shuffle_seed=shuffle_seed,
                 draws={"noise": np.split(noise, d)})
    return case, want


def _sharded_case(d, kind):
    """(b): each device's batch, noise (and roll) from the reference's
    keys, its sharded trainer's epoch metrics, and the device-mean
    gradients of its loss."""
    spec, jm, jd = _spec("VAE" if kind == "infomax" else "CDGVAE")
    mesh = jax_make_mesh(d)
    sh = NamedSharding(mesh, P("dp"))
    lb = BATCH // d
    rng = jax.random.key(21)
    p = _tree(spec, jd)
    x, y = _data(BATCH)
    if kind == "infomax":
        loss_fn = jsteps.make_infomax_loss_fn(jm, jd, BETA, LAM, GAMMA,
                                              marginal="roll")
        opt = jsteps.pair_infomax_optimizer(optax.adam(LR),
                                            optax.adam(LR_D))
    elif kind == "semi":
        loss_fn = jsteps.make_semi_loss_fn(jm, BETA, LAM)
        opt = optax.adam(LR)
    else:
        loss_fn = jscanned.make_supervised_loss_fn(jm, BETA, LAM)
        opt = optax.adam(LR)
    if kind == "semi":
        bl = d  # one labeled row a device
        x_l, y_l = (a[:bl] for a in _data(32, seed=4))
        run = jscanned.make_sharded_scanned_epochs_semi_from_loss(
            loss_fn, opt, mesh, BATCH, bl)
        # the trainer donates its state: give it copies
        _, _, m_j = run(_tree(spec, jd), opt.init(p), jax.device_put(x, sh),
                        jax.device_put(x_l, sh), jax.device_put(y_l, sh),
                        rng, 0)
    else:
        run = jscanned.make_sharded_scanned_epochs_from_loss(
            loss_fn, opt, mesh, BATCH)
        _, _, m_j = run(_tree(spec, jd), opt.init(p), jax.device_put(x, sh),
                        jax.device_put(y, sh), rng, 0)
    rows = {"x": [], "y": [], "x_l": [], "y_l": []}
    draws = {}
    grads = []
    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    for q in range(d):
        ekey = jax.random.fold_in(jax.random.fold_in(rng, 0), q)
        skey = jax.random.fold_in(ekey, 0)
        perm = np.asarray(jax.random.permutation(ekey, lb))
        xq, yq = x[q * lb:(q + 1) * lb][perm], y[q * lb:(q + 1) * lb][perm]
        rows["x"].append(xq)
        rows["y"].append(yq)
        if kind == "semi":
            lkey = jax.random.fold_in(ekey, 2 ** 20)
            perm_l = np.asarray(jax.random.permutation(
                jax.random.fold_in(lkey, 0), 1))
            xl_q, yl_q = x_l[q:q + 1][perm_l], y_l[q:q + 1][perm_l]
            rows["x_l"].append(xl_q)
            rows["y_l"].append(yl_q)
            args = (xq, xl_q, yl_q)
            noise_key = skey
        elif kind == "infomax":
            args = (xq, yq)
            noise_key, r_perm = jax.random.split(skey)
            draws.setdefault("shift", []).append(np.asarray(
                jax.random.randint(r_perm, (), 1, lb)))
        else:
            args = (xq, yq)
            noise_key = skey
        draws.setdefault("noise", []).append(np.asarray(
            jax.random.normal(noise_key, (lb, NODE), jnp.float32)))
        (_, _), g = grad_fn(p, *(jnp.asarray(a) for a in args), skey)
        grads.append(g)
    g_mean = jax.tree.map(lambda *gs: sum(gs) / d, *grads)
    if kind == "infomax":
        want_g = {**{f"model.{k}": v for k, v in _flat(g_mean[0]).items()},
                  **{f"disc.{k}": v for k, v in _flat(g_mean[1]).items()}}
    else:
        want_g = {f"model.{k}": v for k, v in _flat(g_mean).items()}
    want = dict(metrics={k: float(np.asarray(v)[0]) for k, v in m_j.items()},
                grads=want_g)
    case = _case("sharded", spec, batch_size=BATCH, draws=draws,
                 semi=kind == "semi", x=rows["x"], y=rows["y"])
    if kind == "semi":
        case.update(x_l=rows["x_l"], y_l=rows["y_l"], batch_size_l=d)
    return case, want


def _online_case(d):
    """(c): the reference's per-device draws of step 0, the DGP at the
    device's global row offset."""
    spec, _, _ = _spec("CDGVAE")
    lb = BATCH // d
    rng = jax.random.key(31)
    jax_draws, want = [], []
    for q in range(d):
        k = jax.random.fold_in(jax.random.fold_in(rng, 0), q)
        k_data, _ = jax.random.split(k)
        ks = jax.random.split(k_data, 6)
        u = jax.random.uniform
        jax_draws.append([np.array(a) for a in (
            u(ks[0], (lb,), minval=math.pi / 4, maxval=math.pi / 2),
            u(ks[1], (lb,), minval=0.0, maxval=math.pi / 4),
            jax.random.normal(ks[2], (lb,)), jax.random.normal(ks[3], (lb,)),
            u(ks[4], (lb, 2), minval=0.0, maxval=12.0), u(ks[5], (lb,)))])
        want.append(np.asarray(jonline.sample_factors_device(
            k_data, lb, index_offset=q * lb)))
    return _case("online", spec, batch_size=BATCH,
                 jax_draws=jax_draws), want


def _replicated_case():
    spec, _, _ = _spec("CDGVAE")
    x, y = _data(32, seed=6)
    return _case("replicated", spec, x=x, y=y, batch_size=BATCH, epochs=2)


def _batchnorm_case(d):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(4 * d, 3, 5, 5)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    return dict(kind="batchnorm", x=np.split(x, d), w=np.split(w, d),
                scale=rng.uniform(0.5, 1.5, 3).astype(np.float32),
                bias=rng.normal(size=3).astype(np.float32))


def _launch(tmp, d, cases):
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    launch(run_cases, d, "cpu", str(tmp / "cases.pkl"), str(tmp))
    out = []
    for r in range(d):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world size: ([per-rank results], {case: expected})}, two launches
    in all."""
    got = {}
    for d, names in ((2, ("eager", "supervised", "semi", "infomax",
                          "online", "replicated", "batchnorm")),
                     (4, ("eager",))):
        cases, want = {}, {}
        for name in names:
            if name == "eager":
                cases[name], want[name] = _eager_case(d)
            elif name == "online":
                cases[name], want[name] = _online_case(d)
            elif name == "replicated":
                cases[name] = _replicated_case()
            elif name == "batchnorm":
                cases[name] = _batchnorm_case(d)
            else:
                cases[name], want[name] = _sharded_case(d, name)
        got[d] = (_launch(tmp_path_factory.mktemp(f"world{d}"), d, cases),
                  want, cases)
    return got


def _check_step(ranks, want, case):
    """Cross-rank metrics and the reduced gradients against the reference,
    the same gradients on every rank, and each rank's Adam on them."""
    r0 = ranks[0]
    assert sorted(r0["metrics"]) == sorted(want["metrics"])
    assert all(math.isfinite(v) for v in r0["metrics"].values())
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(r0["metrics"][k], v, rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert set(r0["grads"]) == set(want["grads"])
    for name, g in want["grads"].items():
        atol = 1e-6 * float(np.abs(g).max())
        np.testing.assert_allclose(r0["grads"][name], g, rtol=1e-4,
                                   atol=atol, err_msg=name)
    for other in ranks[1:]:
        assert other["metrics"] == r0["metrics"]
        for name in want["grads"]:
            np.testing.assert_array_equal(other["grads"][name],
                                          r0["grads"][name], err_msg=name)
    # Adam on the port's own reduced gradients (a first step is about
    # ±lr·sign(g), so the reference's gradients would flip near-zero ones)
    spec = case["spec"]
    for prefix, key, lr in (("model.", "params", LR),
                            ("disc.", "d_params", LR_D)):
        if spec.get(key) is None:
            continue
        p = jax.tree.map(jnp.asarray, spec[key])
        g = _unflat({k[len(prefix):]: v for k, v in r0["grads"].items()
                     if k.startswith(prefix)})
        opt = optax.adam(lr)
        updates, _ = opt.update(g, opt.init(p), p)
        expect = _flat(optax.apply_updates(p, updates))
        for r in ranks:
            got = _flat(r["params"][prefix[:-1]])
            for k in expect:
                np.testing.assert_allclose(got[k], expect[k], rtol=0,
                                           atol=1e-7, err_msg=prefix + k)


@pytest.mark.parametrize("d", [2, 4])
def test_eager_step_matches_jax_mesh_step(runs, d):
    ranks, want, cases = runs[d]
    _check_step([r["eager"] for r in ranks], want["eager"], cases["eager"])


@pytest.mark.parametrize("d,kind", [(2, "supervised"), (2, "semi"),
                                    (2, "infomax")])
def test_sharded_epoch_matches_jax_sharded_trainer(runs, d, kind):
    ranks, want, cases = runs[d]
    _check_step([r[kind] for r in ranks], want[kind], cases[kind])
    if kind == "infomax":
        assert "MutualInfo" in ranks[0][kind]["metrics"]


def test_online_draws_match_jax_at_the_rank_offset(runs):
    ranks, want, cases = runs[2]
    lb = BATCH // 2
    for r, res in enumerate(ranks):
        assert res["online"]["offsets"] == [r * lb]
        got, ref = res["online"]["factors"][0], want["online"][r]
        np.testing.assert_array_equal(got[:, :2], ref[:, :2])
        np.testing.assert_allclose(got[:, 2:4], ref[:, 2:4], atol=1e-5)
        # the corruption falls on global rows 4, 9, ...: rank 1's row 0
        corrupt = (np.arange(lb) + 1 + r * lb) % 5 == 0
        assert corrupt.any() == (r == 1)
        resample = cases["online"]["jax_draws"][r][4]
        np.testing.assert_array_equal(got[corrupt, 2:4], resample[corrupt])


def test_params_stay_replicated_over_epochs(runs):
    ranks, _, _ = runs[2]
    p0 = _flat(ranks[0]["replicated"]["params"])
    p1 = _flat(ranks[1]["replicated"]["params"])
    for k in p0:
        np.testing.assert_array_equal(p1[k], p0[k], err_msg=k)
    hist = ranks[0]["replicated"]["history"]
    assert hist == ranks[1]["replicated"]["history"] and len(hist) == 2
    assert hist[1]["loss"] < hist[0]["loss"]


def _world1_run(mesh, out):
    spec, _, _ = _spec("CDGVAE")
    B = np.asarray(spec["B"])
    x, y = (torch.from_numpy(a) for a in _data(32, seed=6))
    for m in (None, mesh):
        tm = tvae.CDGVAE(TGraph(B), _row_masks(), FACTOR, image_size=SIZE,
                         hidden=HIDDEN)
        load_jax_params(tm, spec["params"])
        if m is not None:
            replicate(m, tm)
        step = tsteps.make_train_step(tm, tsteps.make_optimizer(tm, LR),
                                      BETA, LAM, mesh=m)
        hist = tloop.run_epochs(step, x, y, seed=SEED, epochs=2,
                                batch_size=BATCH, mesh=m)
        out.append((hist, _flat(export_params(tm))))


def test_world1_mesh_run_equals_the_one_device_run():
    out = []
    launch(_world1_run, 1, "cpu", out)  # one rank: in this process
    (h_one, p_one), (h_mesh, p_mesh) = out
    assert h_mesh == h_one
    for k in p_one:
        np.testing.assert_array_equal(p_mesh[k], p_one[k], err_msg=k)


def test_global_batch_stats_equal_the_whole_batch(runs):
    ranks, _, cases = runs[2]
    case = cases["batchnorm"]
    x = torch.from_numpy(np.concatenate(case["x"])).requires_grad_()
    scale = torch.from_numpy(case["scale"]).requires_grad_()
    bias = torch.from_numpy(case["bias"]).requires_grad_()
    out = tnn.batchnorm(x, scale, bias)
    (out * torch.from_numpy(np.concatenate(case["w"]))).sum().backward()
    got = [r["batchnorm"] for r in ranks]
    np.testing.assert_allclose(np.concatenate([g["out"] for g in got]),
                               out.detach().numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([g["x"] for g in got]),
                               x.grad.numpy(), rtol=1e-4, atol=1e-5)
    for name, t in (("scale", scale), ("bias", bias)):
        np.testing.assert_allclose(sum(g[name] for g in got),
                                   t.grad.numpy(), rtol=1e-5, atol=1e-5)


def test_dryrun_multichip_runs_on_two_gloo_ranks(capfd):
    dryrun_multichip(2, "cpu")
    said = capfd.readouterr().out
    assert "dryrun_multichip(2, gloo): eager loss" in said
    assert said.count("dryrun_multichip") == 1  # rank 0 alone prints
