"""The port's PNG dataset trees against PIL and the JAX package: the
decoder (every scanline filter, RGB and RGBA, PIL's files and the port's
own) exact, the bicubic resize against Pillow's ``Image.resize`` (96 -> 64
and 32 -> 16, within one uint8 level with >= 99% of the pixels exact),
unsupported files refused by name, ``load_png_dataset`` and the datasets'
``data_dir`` branch against the JAX loader on a tree the JAX package
wrote (labels exact, images within 1/127.5), ``save_png_dataset`` against
the JAX writer (the same file names, decoded pixels within one level),
``cli.generate_data``, and ``--data_dir`` through the training and eval
CLIs. Small sizes: 16-96 px, a few dozen files.
"""
import importlib.util
import json
import os
import re
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from cdgvae_tpu.data import png_io as jpng
from cdgvae_tpu.data.pendulum import PendulumDataset as JPendulumDataset
from cdgvae_tpu.data.pendulum import sample_factors_real
from cdgvae_tpu.data.pendulum_dr import PendulumDRDataset as JDRDataset
from cdgvae_tpu.data.pendulum_dr import sample_factors_dr
from cdgvae_torch.cli import generate_data, inference, main_classifier
from cdgvae_torch.cli import main as tmain
from cdgvae_torch.cli import dr_main, main_semi
from cdgvae_torch.data import png_io
from cdgvae_torch.data.pendulum import PendulumDataset
from cdgvae_torch.data.pendulum_dr import PendulumDRDataset
from cdgvae_torch.utils.checkpoint import load_checkpoint
from cdgvae_torch.utils.viz import write_png

LEVEL = 1.0 / 127.5  # one uint8 level after (x - 127.5) / 127.5


def _pictures(seed=0, h=24, w=20):
    """Smooth gradients with a noisy patch, RGB and RGBA (alpha 255, and a
    varying alpha), so PIL's adaptive filters pick several types."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = ((3 * xx[..., None] + 5 * yy[..., None] + 40 * np.arange(4))
            % 256).astype(np.uint8)
    r0, c0 = h // 6, w // 4
    base[r0:r0 + h // 4, c0:c0 + w // 3] = rng.integers(
        0, 256, (h // 4, w // 3, 4))
    rgba = base.copy()
    rgba[..., 3] = 255
    varying = base.copy()
    varying[..., 3] = rng.integers(0, 256, (h, w))
    return {"rgb": base[..., :3].copy(), "rgba": rgba, "rgba alpha": varying}


def _encode(pixels: np.ndarray, filters) -> bytes:
    """A PNG of uint8 [h, w, c] with row r filtered by ``filters[r % len]``
    (the PNG spec's filters written out per byte), for the decoder."""
    h, w, c = pixels.shape
    rows, prev = [], np.zeros(w * c, np.int64)
    for r in range(h):
        cur = pixels[r].reshape(-1).astype(np.int64)
        kind = filters[r % len(filters)]
        out = []
        for i in range(w * c):
            a = cur[i - c] if i >= c else 0
            b = prev[i]
            cc = prev[i - c] if i >= c else 0
            if kind == 0:
                pred = 0
            elif kind == 1:
                pred = a
            elif kind == 2:
                pred = b
            elif kind == 3:
                pred = (a + b) // 2
            else:
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
            out.append((cur[i] - pred) % 256)
        rows.append(bytes([kind]) + bytes(out))
        prev = cur
    return _png_bytes(w, h, 8, {3: 2, 4: 6}[c], 0, zlib.compress(b"".join(
        rows)))


def _png_bytes(w, h, depth, colour, interlace, idat: bytes) -> bytes:
    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0,
                                         0, interlace))
            + chunk(b"IDAT", idat) + chunk(b"IEND", b""))


def _row_filters(path) -> np.ndarray:
    (h, w, c), body = png_io._read_png(str(path))
    return np.frombuffer(body, np.uint8).reshape(h, -1)[:, 0]


def _filter_types(path) -> set:
    return set(_row_filters(path).tolist())


def test_decoder_matches_pil_on_pil_files(tmp_path):
    paths, kinds = [], set()
    for seed in range(3):
        for name, pic in _pictures(seed).items():
            path = tmp_path / f"{seed}_{name.replace(' ', '_')}.png"
            Image.fromarray(pic).save(path)
            paths.append(path)
            kinds |= _filter_types(path)
    assert kinds >= {1, 2, 4}, kinds  # PIL's adaptive choices
    for path, got in zip(paths, png_io.decode_pngs([str(p) for p in paths])):
        np.testing.assert_array_equal(got, np.asarray(Image.open(path)))


@pytest.mark.parametrize("name", ["rgb", "rgba"])
def test_decoder_undoes_every_filter(tmp_path, name):
    pic = _pictures(1, h=10, w=7)[name]
    paths = []
    for k, filters in enumerate([(0,), (1,), (2,), (3,), (4,),
                                 (0, 1, 2, 3, 4), (4, 3, 2, 1, 0)]):
        path = tmp_path / f"{k}.png"
        path.write_bytes(_encode(pic, filters))
        np.testing.assert_array_equal(np.asarray(Image.open(path)), pic)
        paths.append(str(path))
    for got in png_io.decode_pngs(paths):  # each row's filters mixed
        np.testing.assert_array_equal(got, pic)
    for path in paths:  # each row one filter across the files
        np.testing.assert_array_equal(png_io.decode_pngs([path] * 3)[2], pic)


def test_decoder_reads_write_png(tmp_path):
    pic = _pictures(2)["rgb"]
    write_png(str(tmp_path / "a.png"), pic)
    np.testing.assert_array_equal(
        png_io.decode_pngs([str(tmp_path / "a.png")])[0], pic)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")),
                                  pic)


def test_chip_smoke_filters_rows_as_pillow_does(tmp_path):
    """The Pillow-filtered tree on which the GPU smoke run times the
    decoder: its filter bytes are the ones Pillow writes for the same
    pixels, and the decoder reads it back exactly."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    factors, is_test = sample_factors_real(seed=6, n=24)
    png_io.save_png_dataset(str(tmp_path / "tree"), factors, is_test,
                            image_size=48, device="cpu")
    paths = sorted((tmp_path / "tree" / "train").iterdir())
    pixels = np.stack(png_io.decode_pngs([str(p) for p in paths]))
    pics = list(pixels) + [_pictures(s, h=48, w=48)["rgb"] for s in range(3)]
    scan = smoke.pillow_scanlines(np.stack(pics))
    assert set(scan[:, :, 0].ravel().tolist()) >= {0, 1, 2, 4}
    for k, pic in enumerate(pics):
        Image.fromarray(pic).save(tmp_path / f"pil{k}.png")
        smoke.write_scanlines(tmp_path / f"smoke{k}.png", scan[k])
        np.testing.assert_array_equal(scan[k, :, 0],
                                      _row_filters(tmp_path / f"pil{k}.png"))
    got = png_io.decode_pngs([str(tmp_path / f"smoke{k}.png")
                              for k in range(len(pics))])
    for pic, img in zip(pics, got):
        np.testing.assert_array_equal(img, pic)


@pytest.mark.parametrize("case,why", [
    ("palette", "colour type 3 (palette)"),
    ("grey", "colour type 0 (greyscale)"),
    ("16 bit", "bit depth 16"),
    ("interlaced", "interlace method 1"),
])
def test_decoder_refuses_what_it_does_not_read(tmp_path, case, why):
    path = tmp_path / "x.png"
    pic = _pictures(0)["rgb"]
    if case == "palette":
        Image.fromarray(pic).convert("P").save(path)
    elif case == "grey":
        Image.fromarray(pic).convert("L").save(path)
    else:
        depth, interlace = (16, 0) if case == "16 bit" else (8, 1)
        path.write_bytes(_png_bytes(4, 4, depth, 2, interlace,
                                    zlib.compress(b"\0" * 100)))
    with pytest.raises(ValueError, match=re.escape(why)):
        png_io.decode_pngs([str(path)])


@pytest.mark.parametrize("size_in,size_out", [(96, 64), (32, 16), (24, 40)])
@pytest.mark.parametrize("name", ["rgb", "rgba", "rgba alpha"])
def test_resize_matches_pillow(size_in, size_out, name):
    rng = np.random.default_rng(size_in)
    pics = [_pictures(s, h=size_in, w=size_in)[name] for s in range(3)]
    pics.append(rng.integers(0, 256, pics[0].shape).astype(np.uint8))
    got = png_io.resize_bicubic(torch.as_tensor(np.stack(pics)),
                                size_out).numpy()
    want = np.stack([np.asarray(Image.fromarray(p).resize((size_out,
                                                          size_out)))
                     for p in pics])
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
    np.testing.assert_array_equal(got, want)  # exact, in fact


def _jax_tree(tmp_path, n=40, size=32, dr=False):
    if dr:
        train_f, test_f = sample_factors_dr(seed=2, n=n)
        factors = np.concatenate([train_f, test_f])
        is_test = np.arange(len(factors)) >= len(train_f)
    else:
        factors, is_test = sample_factors_real(seed=3, n=n)
    root = str(tmp_path / ("jax_dr" if dr else "jax_tree"))
    jpng.save_png_dataset(root, factors, is_test, image_size=size,
                          background_col=4 if dr else None)
    return root


@pytest.mark.parametrize("size", [16, 32])
def test_load_png_dataset_matches_jax(tmp_path, size):
    root = _jax_tree(tmp_path)
    for split in ("train", "test"):
        want_x, want_y = jpng.load_png_dataset(f"{root}/{split}", size)
        got_x, got_y = png_io.load_png_dataset(f"{root}/{split}", size,
                                               device="cpu")
        np.testing.assert_array_equal(got_y, want_y)
        np.testing.assert_allclose(got_x.numpy(), want_x, rtol=0, atol=LEVEL)
        np.testing.assert_array_equal(got_x.numpy(), want_x)


def test_load_png_dataset_reads_rgba_trees(tmp_path):
    """Trees saved by matplotlib are RGBA with alpha 255."""
    d = tmp_path / "train"
    d.mkdir()
    for k, pic in enumerate(_pictures(4, h=96, w=96).values()):
        if pic.shape[-1] == 4:
            pic = pic.copy()
            pic[..., 3] = 255
        Image.fromarray(pic).save(d / f"a_{k}.0_0.5.png")
    want_x, want_y = jpng.load_png_dataset(str(d), 64)
    got_x, got_y = png_io.load_png_dataset(str(d), 64, device="cpu")
    np.testing.assert_array_equal(got_y, want_y)
    np.testing.assert_array_equal(got_x.numpy(), want_x)


def test_load_empty_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no .png files"):
        png_io.load_png_dataset(str(tmp_path), 16, device="cpu")


def test_load_png_dataset_runs_on_the_card_by_default(tmp_path):
    """Without a device the load resizes on the card, and refuses a
    missing GPU rather than running on the host."""
    write_png(str(tmp_path / "a_0.5_0.25.png"), _pictures(0)["rgb"])
    if torch.cuda.is_available():
        x, _ = png_io.load_png_dataset(str(tmp_path), 16)
        assert x.device.type == "cuda"
    else:
        with pytest.raises(SystemExit, match="no CUDA device"):
            png_io.load_png_dataset(str(tmp_path), 16)


def test_sample_filename_matches_jax():
    for fields in ([0.78539816, 1.0, 12.34567, 0.0, 1.0], [1e-5, -2.00004]):
        assert png_io.sample_filename(fields) == jpng.sample_filename(fields)


@pytest.mark.parametrize("dr", [False, True])
def test_save_png_dataset_matches_jax(tmp_path, dr):
    if dr:
        train_f, test_f = sample_factors_dr(seed=4, n=24)
        factors = np.concatenate([train_f, test_f])
        is_test = np.arange(len(factors)) >= len(train_f)
    else:
        factors, is_test = sample_factors_real(seed=5, n=24)
    kw = dict(image_size=32, background_col=4 if dr else None)
    want = jpng.save_png_dataset(str(tmp_path / "jax"), factors, is_test,
                                 **kw)
    got = png_io.save_png_dataset(str(tmp_path / "port"), factors, is_test,
                                  chunk=10, device="cpu", **kw)
    assert got == want
    for split in ("train", "test"):
        names = sorted(os.listdir(tmp_path / "jax" / split))
        assert sorted(os.listdir(tmp_path / "port" / split)) == names
        ours = png_io.decode_pngs([str(tmp_path / "port" / split / n)
                                   for n in names])
        for name, pic in zip(names, ours):
            ref = np.asarray(Image.open(tmp_path / "jax" / split / name))
            assert np.abs(pic.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("labeled_ratio", [1.0, 0.5])
def test_datasets_data_dir_match_jax(tmp_path, labeled_ratio):
    root = _jax_tree(tmp_path)
    dr_root = _jax_tree(tmp_path, dr=True)
    for train in (True, False):
        for jcls, tcls, r in ((JPendulumDataset, PendulumDataset, root),
                              (JDRDataset, PendulumDRDataset, dr_root)):
            kw = dict(image_size=16, train=train, data_dir=r,
                      labeled_ratio=labeled_ratio)
            want, got = jcls(**kw), tcls(device="cpu", **kw)
            np.testing.assert_array_equal(got.factors, want.factors)
            np.testing.assert_array_equal(got.y_data.numpy(), want.y_data)
            np.testing.assert_allclose(got.x_data.numpy(), want.x_data,
                                       rtol=0, atol=LEVEL)


def test_generate_data_cli(tmp_path, capsys):
    out = tmp_path / "gen"
    n_train, n_test = generate_data.main(
        ["--device", "cpu", "--dgp", "dr", "--out", str(out), "--n", "16",
         "--seed", "5", "--image_size", "24"])
    assert f"wrote {n_train} train / {n_test} test PNGs" in \
        capsys.readouterr().out
    x, labels = png_io.load_png_dataset(str(out / "train"), 24, device="cpu")
    assert labels.shape == (n_train, 6) and x.shape == (n_train, 24, 24, 3)
    train_f, _ = sample_factors_dr(seed=5, n=16)
    assert {tuple(r) for r in labels} == {tuple(r) for r in train_f}


def test_generate_data_refuses_platform(tmp_path, capsys):
    """The reference's --platform: cpu runs on the CPU, a backend the port
    does not run on is refused by name."""
    with pytest.raises(SystemExit):
        generate_data.main(["--out", "x", "--platform", "tpu"])
    assert "--platform tpu is not supported" in capsys.readouterr().err
    out = tmp_path / "gen"
    n_train, n_test = generate_data.main(
        ["--platform", "cpu", "--dgp", "real", "--out", str(out), "--n",
         "8", "--image_size", "16"])
    assert len(os.listdir(out / "train")) == n_train and n_test > 0


def test_main_and_eval_clis_read_the_tree(tmp_path):
    """cli.main --data_dir trains on the tree and records it; cli.inference
    and cli.main_classifier read it (the former from the checkpoint's
    config); main_semi reads both streams from it."""
    root = _jax_tree(tmp_path, n=48)
    run = tmp_path / "run"
    small = ["--device", "cpu", "--image_size", "16", "--batch_size", "8"]
    tmain.main(small + ["--data_dir", root, "--epochs", "1",
                        "--assets_dir", str(run)])
    ck = load_checkpoint(str(run / "model_CDGVAE_linear"))
    assert ck["config"]["data_dir"] == root
    # 36 train files at batch 8: 4 steps
    assert int(ck["opt_state"][0].count) == 4
    with open(run / "model_CDGVAE_linear" / "config.json") as f:
        assert json.load(f)["data_dir"] == root
    grid = inference.main(["--device", "cpu", "--checkpoint",
                           str(run / "model_CDGVAE_linear"),
                           "--assets_dir", str(tmp_path / "inf")])
    assert grid.shape == (4, 7, 16, 16, 3)
    main_classifier.main(small + ["--data_dir", root, "--epochs", "1",
                                  "--assets_dir", str(tmp_path / "clf")])
    assert load_checkpoint(str(tmp_path / "clf" / "CDMClassifier"))[
        "config"]["data_dir"] == root
    main_semi.main(small + ["--data_dir", root, "--epochs", "1",
                            "--labeled_ratio", "0.5", "--batch_sizeL", "4",
                            "--assets_dir", str(tmp_path / "semi")])
    semi = load_checkpoint(str(tmp_path / "semi" /
                               "model_CDGVAEsemi_nonlinear"))
    assert semi["config"]["data_dir"] == root
    assert int(semi["opt_state"][0].count) == 4


def test_dr_main_reads_the_tree(tmp_path):
    root = _jax_tree(tmp_path, n=40, dr=True)
    dr_main.main(["--device", "cpu", "--image_size", "16", "--batch_size",
                  "8", "--data_dir", root, "--epochs", "1", "--assets_dir",
                  str(tmp_path / "dr")])
    ck = load_checkpoint(str(tmp_path / "dr" / "model_DR_CDGVAE_linear"))
    assert ck["config"]["data_dir"] == root and ck["config"]["spurious"]
    assert int(ck["opt_state"][0].count) == 30 // 8


@pytest.mark.parametrize("cli", [tmain, main_semi])
def test_online_with_data_dir_is_refused(tmp_path, cli):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--device", "cpu", "--online", "--data_dir", "pngs",
                  "--assets_dir", str(tmp_path)])
    assert "--online supports the scanned path on the synthetic" in \
        str(exc.value.code)
