"""The port's CelebA trainer and serving on the CPU, at 32 px, conv_dim 4,
on the 64 synthetic faces: ``cli.celeba_main`` with ``--resume`` equal bit
for bit to the uninterrupted run, every flag of the JAX CLI, the no-CUDA
exit; ``LoadedModel`` on a JAX-written CelebA checkpoint against the JAX
package's ``LoadedModel`` with its noise draws fed in (and the same
checkpoint in the stacked decoder format, equal); and the bf16 loss
against the JAX bf16 loss.

Tolerances, float32 on the CPU: served answers at batch 16 rtol 1e-5,
atol 1e-4 (the encoder's last BatchNorms see 16 values a channel at 32
px; measured max |d| 5.1e-5 with two threads). bf16: the loss within 2e-2 relative of the JAX bf16
loss, with the same draws (bfloat16 keeps 8 bits of mantissa).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cdgvae_tpu.api import LoadedModel as JLoadedModel
from cdgvae_tpu.models import celeba as jceleba
from cdgvae_tpu.ops.causal import CausalGraph as JGraph
from cdgvae_tpu.train import celeba_steps as jsteps
from cdgvae_tpu.utils import checkpoint as jck
from cdgvae_torch.api import LoadedModel
from cdgvae_torch.cli import celeba_main
from cdgvae_torch.data.celeba import synthetic_celeba
from cdgvae_torch.factory import build_celeba_model
from cdgvae_torch.models import celeba as tceleba
from cdgvae_torch.train import celeba_steps as tsteps
from cdgvae_torch.utils import checkpoint as tck
from cdgvae_torch.utils.interop import export_params, load_jax_params

SIZE, CONV = 32, 4
SMALL = ["--device", "cpu", "--img_size", str(SIZE), "--conv_dim",
         str(CONV)]
N_BLOCKS = 3


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the host's
    cores, and the ResNet's CPU convolutions on every core of every worker
    oversubscribe it many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _run(tmp_path, name, *extra, epochs=2):
    out = tmp_path / name
    celeba_main.main(SMALL + ["--epochs", str(epochs), "--assets_dir",
                              str(out), *extra])
    return out, out / "celeba_CDGVAE_linear"


def _records(out):
    with open(out / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _assert_trees_equal(a, b):
    jax.tree.map(np.testing.assert_array_equal, a, b)


def test_resume_continues_bit_for_bit(tmp_path):
    full, ck_full = _run(tmp_path, "full", epochs=2)
    part, ck_part = _run(tmp_path, "part", "--ckpt_every", "1", epochs=1)
    assert sorted(p.name for p in part.iterdir()) == [
        "celeba_CDGVAE_linear", "metrics.jsonl", "tmp_image_0.png"]
    _run(tmp_path, "part", "--resume", str(ck_part), epochs=2)
    a, b = tck.load_checkpoint(str(ck_full)), tck.load_checkpoint(
        str(ck_part))
    assert a["step"] == b["step"] == 2
    _assert_trees_equal(a["params"], b["params"])
    _assert_trees_equal(a["opt_state"][0], b["opt_state"][0])
    assert int(a["opt_state"][0].count) == 2 * 4  # 64 images, batch 16
    assert [r["loss"] for r in _records(full)] == \
        [r["loss"] for r in _records(part)]
    # the JAX package reads the port's checkpoint
    j = jck.load_checkpoint(str(ck_part))
    assert type(j["opt_state"][0]).__name__ == "ScaleByAdamState"
    assert j["config"]["img_size"] == SIZE
    with pytest.raises(ValueError, match="already >= --epochs"):
        _run(tmp_path, "part", "--resume", str(ck_part), epochs=2)


@pytest.mark.parametrize("flag", [
    "eager", "align_warmup", "bf16", "train_trunk", "stacked_decoder",
    "async_ckpt", "packed_params", "torch_weights", "profile"])
def test_every_flag(tmp_path, flag, capsys):
    if flag == "eager":
        out, ck = _run(tmp_path, flag, "--eager")
        # the same full batches as the epoch runner: 4 steps an epoch
        assert int(tck.load_checkpoint(str(ck))["opt_state"][0].count) == 8
    elif flag == "align_warmup":
        out, ck = _run(tmp_path, flag, "--align_warmup", "1")
        first, second = _records(out)
        assert first["loss"] == pytest.approx(5 * first["alignment"],
                                              rel=1e-6)
        assert second["loss"] > 5 * second["alignment"] + 100
        # the decoder stepped with zero gradients: optax's one count
        adam = tck.load_checkpoint(str(ck))["opt_state"][0]
        assert int(adam.count) == 8
    elif flag == "bf16":
        out, ck = _run(tmp_path, flag, "--bf16")
        params = tck.load_checkpoint(str(ck))["params"]
        assert params["decoder"]["gen0"]["toRGB"]["w"].dtype == np.float32
        assert all(np.isfinite(r["loss"]) for r in _records(out))
    elif flag == "train_trunk":
        out, ck = _run(tmp_path, flag, "--train_trunk", epochs=1)
        base, base_ck = _run(tmp_path, "base", epochs=1)
        mu = tck.load_checkpoint(str(ck))["opt_state"][0].mu
        frozen = tck.load_checkpoint(str(base_ck))["opt_state"][0].mu
        assert np.abs(mu["encoder"]["stem_conv"]["w"]).max() > 0
        assert not frozen["encoder"]["stem_conv"]["w"].any()
        assert json.load(open(ck / "config.json"))["train_trunk"] is True
    elif flag == "stacked_decoder":
        out, ck = _run(tmp_path, flag, "--stacked_decoder", "true")
        ckd = tck.load_checkpoint(str(ck))
        assert set(ckd["params"]["decoder"]) == {"stacked"}
        assert set(ckd["opt_state"][0].mu["decoder"]) == {"stacked"}
        w = ckd["params"]["decoder"]["stacked"]["block0"]["linear"]["w"]
        assert w.shape[:2] == (5, 6) and not w[0, 2:].any()
        # a resumed run keeps the checkpoint's format, and says so
        capsys.readouterr()
        _run(tmp_path, flag, "--resume", str(ck), epochs=3)
        said = capsys.readouterr().out
        assert "resumed from" in said and "WARNING" in said
        assert set(tck.load_checkpoint(str(ck))["params"]["decoder"]) == \
            {"stacked"}
        # the JAX package's stacked model trains on it
        assert "stacked" in jck.load_checkpoint(str(ck))["params"]["decoder"]
    elif flag == "async_ckpt":
        out, ck = _run(tmp_path, flag, "--async_ckpt", "true",
                       "--ckpt_every", "1", epochs=1)
        _, sync = _run(tmp_path, "sync", "--ckpt_every", "1", epochs=1)
        assert (ck / "state.pkl").read_bytes() == \
            (sync / "state.pkl").read_bytes()
        assert (out / "tmp_image_0.png").exists()
    elif flag == "packed_params":
        _, ck = _run(tmp_path, "packed", "--packed_params", "true",
                     epochs=1)
        _, unpacked = _run(tmp_path, flag, "--packed_params", "false",
                           "--chunk", "3", epochs=1)
        assert (ck / "state.pkl").read_bytes() == \
            (unpacked / "state.pkl").read_bytes()
        cfg = json.load(open(unpacked / "config.json"))
        assert cfg["packed_params"] is False and cfg["chunk"] == 3
    elif flag == "torch_weights":
        sd = _torchvision_state_dict(torch.Generator().manual_seed(0))
        torch.save(sd, tmp_path / "resnet18.pt")
        out, ck = _run(tmp_path, flag, "--torch_weights",
                       str(tmp_path / "resnet18.pt"), epochs=1)
        bn = tck.load_checkpoint(str(ck))["params"]["encoder"]["stem_bn"]
        np.testing.assert_array_equal(bn["var"], sd["bn1.running_var"])
        # the frozen imported trunk does not move
        np.testing.assert_array_equal(
            tck.load_checkpoint(str(ck))["params"]["encoder"]["stem_conv"]
            ["w"], sd["conv1.weight"].numpy().transpose(2, 3, 1, 0))
        served = LoadedModel.load(str(ck), device="cpu")
        assert served.model.encoder.stem_bn.mean is not None
    elif flag == "profile":
        out, ck = _run(tmp_path, flag, "--profile", str(tmp_path / "trace"),
                       epochs=1)
        from cdgvae_torch.utils.profiling import rank_ops
        assert rank_ops(str(tmp_path / "trace"), category="cpu_op")
    assert ck.is_dir()


def _torchvision_state_dict(g):
    sd = {}

    def conv(name, o, i, k):
        sd[name + ".weight"] = 0.05 * torch.randn(o, i, k, k, generator=g)

    def bn(name, c):
        sd[name + ".weight"] = 0.5 + torch.rand(c, generator=g)
        sd[name + ".bias"] = 0.1 * torch.randn(c, generator=g)
        sd[name + ".running_mean"] = 0.1 * torch.randn(c, generator=g)
        sd[name + ".running_var"] = 0.5 + torch.rand(c, generator=g)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    in_ch = 64
    for li, w in enumerate([64, 128, 256, 512]):
        for bi in range(2):
            p = f"layer{li + 1}.{bi}"
            conv(p + ".conv1", w, in_ch, 3)
            bn(p + ".bn1", w)
            conv(p + ".conv2", w, w, 3)
            bn(p + ".bn2", w)
            if in_ch != w:
                conv(p + ".downsample.0", w, in_ch, 1)
                bn(p + ".downsample.1", w)
            in_ch = w
    return sd


def test_needs_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(SystemExit, match="no CUDA device"):
        celeba_main.main(["--img_size", str(SIZE), "--conv_dim", str(CONV),
                          "--epochs", "1", "--assets_dir",
                          str(tmp_path / "x")])
    # --dp is ported: on the GPU, more ranks than visible GPUs are refused
    # with the device count
    with pytest.raises(SystemExit, match="2-device mesh"):
        celeba_main.main(["--img_size", str(SIZE), "--conv_dim", str(CONV),
                          "--dp", "2", "--assets_dir",
                          str(tmp_path / "y")])


# ----------------------------------------------------------------- serving

def _jax_decoder_noise(r_dec, batch, dtype=jnp.float32):
    """The JAX decoder's draws under ``r_dec``: K generators' keys, then
    each generator's sites (``models/sagan.py:252``, ``:332-345``)."""
    out = []
    for rk in jax.random.split(r_dec, 5):
        rs = jax.random.split(rk, N_BLOCKS + 1)
        sites = [jax.random.normal(rs[0], (batch, 4, 4, 1), dtype)]
        for i in range(N_BLOCKS):
            s = 4 * 2 ** (i + 1)
            sites += [jax.random.normal(r, (batch, s, s, 1), dtype)
                      for r in jax.random.split(rs[i + 1])]
        # bfloat16 draws as float32 (exact), for torch
        out.append([np.asarray(v, np.float64 if dtype == jnp.float64
                               else np.float32) for v in sites])
    return out


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A CelebA checkpoint written by the JAX package: the config
    cli.celeba_main records, params drawn by the port with the noise
    weights and attention gates redrawn."""
    config = vars(celeba_main.get_args(SMALL))
    tm = build_celeba_model(config, device="cpu", seed=2)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in tm.named_parameters():
            if name.endswith(("weight", "sigma")):
                p.copy_(0.2 * torch.randn(p.shape, generator=g))
    params = export_params(tm)
    path = str(tmp_path_factory.mktemp("celeba") / "ck")
    jck.save_checkpoint(path, jax.tree.map(jnp.asarray, params),
                        config=config)
    return path, params, config


def test_loaded_model_serves_a_jax_checkpoint(jax_checkpoint, tmp_path):
    path, params, config = jax_checkpoint
    served = LoadedModel.load(path, device="cpu")
    jserved = JLoadedModel.load(path)
    x, _ = synthetic_celeba(16, SIZE, seed=4)

    def close(a, b):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-4)

    z = served.encode(x)
    assert z.shape == (16, 6)
    close(z, jserved.encode(x))
    # JAX reconstructs with model(..., rng=key(0)): the decoder draws
    # under split(key(0))[1]; the counterfactual decodes under key(0)
    r_dec = jax.random.split(jax.random.key(0))[1]
    recon = served.reconstruct(x, noise=_jax_decoder_noise(r_dec, 16))
    close(recon, jserved.reconstruct(x))
    cf_noise = _jax_decoder_noise(jax.random.key(0), 16)
    cf = served.counterfactual(x, 1, 0.7, noise=cf_noise)
    assert cf.shape == (16, SIZE, SIZE, 3)
    close(cf, jserved.counterfactual(x, do_index=1, value=0.7))
    # the default noise: a CPU generator seeded 0, the same every call
    np.testing.assert_array_equal(served.reconstruct(x),
                                  served.reconstruct(x))
    with pytest.raises(ValueError, match="segmentation masks"):
        served.sample(4)
    # the same checkpoint in the stacked decoder format serves the same
    graph = JGraph(jceleba.celeba_B(jceleba.SMILE_NODES, 0))
    jm = jceleba.CelebACDGVAE(graph, latent_dim=6, image_size=SIZE,
                              conv_dim=CONV)
    stacked = str(tmp_path / "stacked")
    jck.save_checkpoint(stacked, jm.stack_decoder(
        jax.tree.map(jnp.asarray, params)), config=config)
    served = LoadedModel.load(stacked, device="cpu")
    np.testing.assert_array_equal(served.encode(x), z)
    np.testing.assert_array_equal(served.reconstruct(
        x, noise=_jax_decoder_noise(r_dec, 16)), recon)
    np.testing.assert_array_equal(served.counterfactual(
        x, 1, 0.7, noise=cf_noise), cf)


def test_bf16_loss_matches_jax(jax_checkpoint):
    _, params, config = jax_checkpoint
    tm = build_celeba_model(config, device="cpu", seed=5)
    load_jax_params(tm, params)
    graph = JGraph(jceleba.celeba_B(jceleba.SMILE_NODES, 0))
    jm = jceleba.CelebACDGVAE(graph, latent_dim=6, image_size=SIZE,
                              conv_dim=CONV)
    x, y = synthetic_celeba(16, SIZE, seed=6)
    rng = jax.random.key(13)
    jloss, jmet = jax.jit(jsteps.make_celeba_loss_fn(
        jm, 0.1, 5.0, compute_dtype=jnp.bfloat16))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(y),
        rng)
    # the JAX draws in bfloat16, as its bf16 forward draws them
    r_enc, r_dec = jax.random.split(rng)
    draws = tceleba.CelebANoise(
        *(np.asarray(jax.random.normal(r, (16, 6), jnp.bfloat16),
                     np.float32) for r in jax.random.split(r_enc)),
        _jax_decoder_noise(r_dec, 16, jnp.bfloat16))
    loss, met = tsteps.make_celeba_loss_fn(
        tm, 0.1, 5.0, compute_dtype=torch.bfloat16)(
        torch.from_numpy(x), torch.from_numpy(y), noise=draws)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-2)
    np.testing.assert_allclose(met["alignment"].item(),
                               float(jmet["alignment"]), rtol=2e-2)

