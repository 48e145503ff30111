"""Parity of the port's core math (cdgvae_torch nn, flows, causal graph,
losses) with the JAX package on shared inputs, gradients included.

Inputs are made with numpy from a seed; parameters are drawn by the JAX
package and copied into the port with ``load_jax_params``.
Tolerances, float32 on the CPU: values rtol 1e-5 / atol 1e-6; gradients
rtol 1e-4 with atol 1e-6 * max|g| (sums taken in another order).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cdgvae_tpu import nn as jnn
from cdgvae_tpu.ops import causal as jcausal
from cdgvae_tpu.ops import flows as jflows
from cdgvae_tpu.ops import losses as jlosses
from cdgvae_torch import nn as tnn
from cdgvae_torch.ops import causal as tcausal
from cdgvae_torch.ops import flows as tflows
from cdgvae_torch.ops import losses as tlosses
from cdgvae_torch.utils.interop import load_jax_params

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-6


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float32,
                        requires_grad=grad)


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a.detach() if torch.is_tensor(a)
                                          else a),
                               np.asarray(b), rtol=rtol, atol=atol)


def _grad_close(g_torch, g_jax):
    g_jax = np.asarray(g_jax)
    atol = GRAD_ATOL_REL * float(np.abs(g_jax).max())
    np.testing.assert_allclose(g_torch.detach().numpy(), g_jax,
                               rtol=GRAD_RTOL, atol=atol)


def _param_grads_close(module, jax_grads, prefix=""):
    flat = {}

    def walk(tree, pre):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{pre}{k}.")
            else:
                flat[f"{pre}{k}"] = v

    walk(jax_grads, prefix)
    params = dict(module.named_parameters())
    assert set(params) == set(flat)
    for name, p in params.items():
        _grad_close(p.grad, flat[name])


@pytest.mark.parametrize("final", [None, "tanh"])
def test_mlp_matches_jax(final):
    params = jnn.mlp_init(jax.random.key(0), [12, 16, 16, 5])
    x = np.random.default_rng(0).standard_normal((6, 12)).astype(np.float32)
    j_final = jnp.tanh if final else None
    t_final = torch.tanh if final else None

    def j_loss(p, x):
        return jnp.sum(jnn.mlp(p, x, final_activation=j_final) ** 2)

    y_j = jnn.mlp(params, jnp.asarray(x), final_activation=j_final)
    g_p, g_x = jax.grad(j_loss, argnums=(0, 1))(params, jnp.asarray(x))

    mlp = tnn.MLP([12, 16, 16, 5])
    load_jax_params(mlp, _np_tree(params))
    xt = _t(x, grad=True)
    y_t = mlp(xt, final_activation=t_final)
    _close(y_t, y_j)
    (y_t ** 2).sum().backward()
    _grad_close(xt.grad, g_x)
    _param_grads_close(mlp, g_p)


def test_stacked_mlp_matches_jax():
    params = jnn.stacked_mlp_init(jax.random.key(1), 3, [5, 8, 7])
    x = np.random.default_rng(1).standard_normal((3, 6, 5)).astype(np.float32)

    def j_loss(p, x):
        return jnp.sum(jnp.sin(jnn.stacked_mlp(p, x)))

    y_j = jnn.stacked_mlp(params, jnp.asarray(x))
    g_p, g_x = jax.grad(j_loss, argnums=(0, 1))(params, jnp.asarray(x))

    mlp = tnn.StackedMLP(3, [5, 8, 7])
    load_jax_params(mlp, _np_tree(params))
    xt = _t(x, grad=True)
    y_t = mlp(xt)
    _close(y_t, y_j)
    torch.sin(y_t).sum().backward()
    _grad_close(xt.grad, g_x)
    _param_grads_close(mlp, g_p)


@pytest.mark.parametrize("scm,flow_num", [("linear", 1), ("nonlinear", 1),
                                          ("nonlinear", 3)])
def test_flows_match_jax(scm, flow_num):
    j = jflows.SCMFlows(scm, node=4, flow_num=flow_num, inverse_loop=100)
    params = j.init(jax.random.key(2))
    eps = np.random.default_rng(2).standard_normal((6, 4)).astype(np.float32)
    w = np.random.default_rng(3).standard_normal((6, 4)).astype(np.float32)

    def j_loss(p, e):
        z, logdet = j.forward(p, e)
        return jnp.sum(z * w) + jnp.sum(logdet)

    z_j, ld_j = j.forward(params, jnp.asarray(eps))
    inv_j = j.inverse(params, z_j)
    g_p, g_e = jax.grad(j_loss, argnums=(0, 1))(params, jnp.asarray(eps))

    t = tflows.SCMFlows(scm, node=4, flow_num=flow_num, inverse_loop=100)
    load_jax_params(t, _np_tree(params))
    et = _t(eps, grad=True)
    z_t, ld_t = t(et)
    _close(z_t, z_j)
    _close(ld_t, ld_j)
    _close(t.inverse(_t(z_j)), inv_j)
    ((z_t * _t(w)).sum() + ld_t.sum()).backward()
    _grad_close(et.grad, g_e)
    _param_grads_close(t, g_p)


def test_build_u_matches_jax():
    rng = np.random.default_rng(4)
    u, w = (rng.standard_normal(9).astype(np.float32) for _ in range(2))
    _close(tflows._build_u(_t(u), _t(w)),
           jflows._build_u(jnp.asarray(u), jnp.asarray(w)))


def test_adjacency_helpers_match_jax():
    B = np.zeros((4, 4))
    B[0, 2] = B[0, 3] = B[1, 2] = B[1, 3] = 1.0
    np.testing.assert_array_equal(tcausal.scale_adjacency(B),
                                  jcausal.scale_adjacency(B))
    cyclic = B.copy()
    cyclic[3, 0] = 1.0
    for W in (B, cyclic, np.zeros((3, 3))):
        assert tcausal.is_dag(W) == jcausal.is_dag(W)
    assert not tcausal.is_dag(cyclic)
    with pytest.raises(ValueError):
        tcausal.CausalGraph(cyclic)


@pytest.mark.parametrize("scm", ["linear", "nonlinear"])
def test_causal_graph_matches_jax(scm):
    B = np.zeros((4, 4))
    B[0, 2] = B[0, 3] = B[1, 2] = B[1, 3] = 1.0
    B = jcausal.scale_adjacency(B)
    jg = jcausal.CausalGraph(B, scm=scm, flow_num=2, inverse_loop=100)
    params = jg.init(jax.random.key(5))
    eps = np.random.default_rng(5).standard_normal((6, 4)).astype(np.float32)

    def j_loss(p, e):
        o, z, ld = jg.transform(p, e)
        return jnp.sum(o * z) + jnp.sum(ld)

    outs_j = jg.transform(params, jnp.asarray(eps))
    inv_j = jg.inverse(params, outs_j[1])
    g_p, g_e = jax.grad(j_loss, argnums=(0, 1))(params, jnp.asarray(eps))

    tg = tcausal.CausalGraph(B, scm=scm, flow_num=2, inverse_loop=100)
    load_jax_params(tg, _np_tree(params))
    et = _t(eps, grad=True)
    outs_t = tg.transform(et)
    for a, b in zip(outs_t, outs_j):
        _close(a, b)
    _close(tg.inverse(_t(outs_j[1])), inv_j)
    _close(tg.I_B_inv, jg.I_B_inv)
    o, z, ld = outs_t
    ((o * z).sum() + ld.sum()).backward()
    _grad_close(et.grad, g_e)
    _param_grads_close(tg, g_p)


def _loss_inputs():
    rng = np.random.default_rng(6)
    xhat = rng.uniform(-1, 1, (6, 4, 4, 3)).astype(np.float32)
    x = rng.uniform(-1, 1, (6, 4, 4, 3)).astype(np.float32)
    mean = rng.standard_normal((6, 4)).astype(np.float32) * 0.3
    logvar = rng.standard_normal((6, 4)).astype(np.float32) * 0.5
    # logits across the saturating range of the stable BCE form
    z = (rng.standard_normal((6, 4)) * 20).astype(np.float32)
    y = rng.uniform(0, 1, (6, 4)).astype(np.float32)
    return dict(xhat=xhat, x=x, mean=mean, logvar=logvar, z=z, y=y)


LOSS_CASES = {
    "gaussian_recon": (("xhat", "x"), {}),
    "kl_std_normal": (("mean", "logvar"), {}),
    "kl_std_normal_free_bits": (("mean", "logvar"), {"free_bits": 0.05}),
    "alignment_bce": (("z", "y"), {}),
    "stable_bce": (("z", "y"), {}),
    "posterior_variance": (("logvar",), {}),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_losses_match_jax(name):
    keys, kw = LOSS_CASES[name]
    inp = _loss_inputs()
    j_fn, t_fn = getattr(jlosses, name), getattr(tlosses, name)
    j_args = [jnp.asarray(inp[k]) for k in keys]
    t_args = [_t(inp[k], grad=True) for k in keys]

    val_j = j_fn(*j_args, **kw)
    grads_j = jax.grad(lambda *a: jnp.sum(j_fn(*a, **kw)),
                       argnums=tuple(range(len(keys))))(*j_args)
    val_t = t_fn(*t_args, **kw)
    _close(val_t, val_j)
    val_t.sum().backward()
    for a, g in zip(t_args, grads_j):
        _grad_close(a.grad, g)


def test_free_bits_zero_is_plain_kl():
    inp = _loss_inputs()
    mean, logvar = _t(inp["mean"]), _t(inp["logvar"])
    kl_dim = 0.5 * (mean ** 2 - logvar + torch.exp(logvar) - 1).mean(0)
    torch.testing.assert_close(tlosses.kl_std_normal_free_bits(mean, logvar,
                                                               0.0),
                               kl_dim.sum())
    torch.testing.assert_close(tlosses.kl_std_normal(mean, logvar),
                               kl_dim.sum())


def _pendulum_B():
    B = np.zeros((4, 4))
    B[0, 2] = B[0, 3] = B[1, 2] = B[1, 3] = 1.0
    return jcausal.scale_adjacency(B)


@pytest.mark.parametrize("scm", ["linear", "nonlinear"])
def test_do_intervention_matches_jax(scm):
    """ancestral_propagate and do_intervention on every node, with a
    scalar and a per-row value. The nonlinear inverse is 100 Picard steps
    in float32 on both sides, held to the same tolerances."""
    B = _pendulum_B()
    jg = jcausal.CausalGraph(B, scm=scm, flow_num=2, inverse_loop=100)
    params = jg.init(jax.random.key(7))
    tg = tcausal.CausalGraph(B, scm=scm, flow_num=2, inverse_loop=100)
    load_jax_params(tg, _np_tree(params))
    rng = np.random.default_rng(7)
    latent, eps, z_struct = (rng.standard_normal((6, 4)).astype(np.float32)
                             for _ in range(3))
    per_row = rng.uniform(-1, 1, 6).astype(np.float32)
    assert tg.topo_ordered and jg.topo_ordered
    for do_index in range(4):
        _close(tg.ancestral_propagate(_t(z_struct), _t(eps), do_index),
               jg.ancestral_propagate(jnp.asarray(z_struct),
                                      jnp.asarray(eps), do_index))
        for value, t_value in ((0.7, 0.7), (per_row, _t(per_row))):
            want = jg.do_intervention(params, jnp.asarray(latent),
                                      jnp.asarray(eps), do_index,
                                      jnp.asarray(value))
            got = tg.do_intervention(_t(latent), _t(eps), do_index, t_value)
            _close(got, want)


def test_ancestral_propagate_refuses_unordered_B():
    B = np.zeros((3, 3))
    B[2, 0] = 1.0  # a DAG, but node 0 depends on node 2
    jg, tg = jcausal.CausalGraph(B), tcausal.CausalGraph(B)
    assert not jg.topo_ordered and not tg.topo_ordered
    z = np.zeros((2, 3), np.float32)
    with pytest.raises(ValueError, match="topologically ordered"):
        jg.ancestral_propagate(jnp.asarray(z), jnp.asarray(z), 1)
    with pytest.raises(ValueError, match="topologically ordered"):
        tg.ancestral_propagate(_t(z), _t(z), 1)
