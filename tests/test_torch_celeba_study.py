"""The port's CelebA study (``cdgvae_torch/tools/celeba_study.py``)
against the JAX script ``scripts/celeba_study.py``, on the CPU:

- the corpus writer equals the script's ``write_corpus`` byte for byte,
  every ``.npy`` file of both splits;
- the port's ``evaluate`` and the script's own ``evaluate`` on one tiny
  checkpoint (32 px, conv_dim 4, 8 test faces) that the port writes in
  the JAX format and both packages load: the recon L1 and every entry of
  the correlation diagonal and the largest off-diagonals within 1e-5
  (both rounded as the script rounds), the do-leakage exactly 0.0 on
  both. The checkpoint is the port's init, whose noise-injection weights
  are zero, so the two packages' decoder noise draws do not enter;
- the flags (by destination) and their defaults are the script's, but
  ``--retry_wait`` and ``--workdir`` (the card's, in the checkout), plus
  the port's ``--device`` and ``--out``; the per-seed and summary keys
  are the script's, plus the summary's ``device`` and ``card``.

The script's functions are read from its source and run without its
module body, which would set JAX's compilation cache under the home
directory.
"""
import argparse
import ast
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from cdgvae_tpu.data.celeba import synthetic_celeba as jax_synthetic_celeba
from cdgvae_torch.cli.celeba_main import get_args as celeba_args
from cdgvae_torch.factory import build_celeba_model
from cdgvae_torch.tools import celeba_study
from cdgvae_torch.utils.checkpoint import save_checkpoint
from cdgvae_torch.utils.interop import export_params

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / \
    "celeba_study.py"
SIZE, CONV, N_TEST = 32, 4, 8
PORT_ONLY = {"device": "cuda", "out": ""}
CARD_DEFAULTS = ("retry_wait", "workdir")


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tree():
    return ast.parse(SCRIPT.read_text())


def _script_functions(*names) -> dict:
    """The script's functions ``names``, compiled without its module
    body, in a namespace with what they read at module level."""
    fns = [n for n in _tree().body
           if isinstance(n, ast.FunctionDef) and n.name in names]
    ns = {"np": np, "os": os, "json": __import__("json"),
          "synthetic_celeba": jax_synthetic_celeba,
          "REPO": str(SCRIPT.parent.parent)}
    exec(compile(ast.Module(fns, type_ignores=[]), str(SCRIPT), "exec"), ns)
    return ns


def _script_flags() -> dict:
    """{destination: default} of the script's ``add_argument`` calls."""
    flags = {}
    for node in ast.walk(_tree()):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            dest = ast.literal_eval(kw["dest"]) if "dest" in kw \
                else node.args[0].value.lstrip("-")
            flags[dest] = ast.literal_eval(kw["default"]) \
                if "default" in kw else False  # store_true
    return flags


def _dict_keys(fn_name: str, holder: str | None) -> set:
    """The keys of the dict ``fn_name`` returns (``holder`` None) or
    assigns to ``holder``."""
    fn = next(n for n in _tree().body
              if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    for node in ast.walk(fn):
        value = None
        if holder is None and isinstance(node, ast.Return):
            value = node.value
        elif (holder is not None and isinstance(node, ast.Assign)
              and getattr(node.targets[0], "id", "") == holder):
            value = node.value
        if isinstance(value, ast.Dict):
            return {k.value for k in value.keys if k is not None}
    raise AssertionError(f"no dict in {fn_name}")


def test_corpus_is_the_scripts_byte_for_byte(tmp_path):
    write = _script_functions("write_corpus")["write_corpus"]
    write(str(tmp_path / "jax"), 6, 4, SIZE, 3)
    celeba_study.write_corpus(str(tmp_path / "port"), 6, 4, SIZE, 3)
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*.npy"))
    assert len(files) == 2 * (6 + 4)
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*.npy"))
    for f in files:
        assert (tmp_path / "jax" / f).read_bytes() == \
            (tmp_path / "port" / f).read_bytes(), f


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A corpus and the port's init checkpoint in the JAX format."""
    base = tmp_path_factory.mktemp("celeba_study")
    celeba_study.write_corpus(str(base / "corpus"), 4, N_TEST, SIZE, 1)
    config = vars(celeba_args(["--img_size", str(SIZE), "--conv_dim",
                               str(CONV), "--device", "cpu", "--lambda",
                               "2000"]))
    model = build_celeba_model(config, device="cpu", seed=7)
    assert all(not p.detach().any()
               for n, p in model.named_parameters() if "noise" in n)
    ckpt = str(base / "ck")
    save_checkpoint(ckpt, export_params(model), step=config["epochs"],
                    config=config)
    return str(base / "corpus"), ckpt


def test_evaluate_matches_the_scripts(tiny):
    corpus, ckpt = tiny
    jax_eval = _script_functions("evaluate")["evaluate"]
    want = jax_eval(argparse.Namespace(img_size=SIZE, tag=""), corpus,
                    ckpt, None, False)
    args = celeba_study.get_args(["--img_size", str(SIZE), "--device",
                                  "cpu"])
    got = celeba_study.evaluate(args, corpus, ckpt, None, False)
    assert got.keys() == want.keys() == _dict_keys("evaluate", None)
    assert abs(got["test_recon_l1"] - want["test_recon_l1"]) <= 1e-5
    for key in ("latent_attr_corr_diag", "latent_attr_corr_max_offdiag"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5,
                                   err_msg=key)
    assert got["do_leakage_outside_masks"] == [0.0] * 6
    assert want["do_leakage_outside_masks"] == [0.0] * 6
    for key in ("seed", "epochs", "lambda", "conv_dim", "train_trunk",
                "nodes", "train_wall_s"):
        assert got[key] == want[key], key


def test_report_has_the_scripts_keys(tiny, tmp_path):
    corpus, ckpt = tiny
    args = celeba_study.get_args(["--img_size", str(SIZE), "--device", "cpu",
                                  "--out", str(tmp_path / "s.json")])
    per_seed = [celeba_study.evaluate(args, corpus, ckpt, 12.5, True,
                                      str(tmp_path / "do.png"))]
    summary = celeba_study.report(args, per_seed)
    assert set(summary) == _dict_keys("report", "out") | {"device", "card"}
    assert summary["do_leakage_max"] == 0.0
    assert summary["device"] == "cpu" and summary["card"] is None
    assert (tmp_path / "s.json").is_file() and (tmp_path / "do.png").is_file()
    assert summary["per_seed"][0]["train_wall_s"] == 12.5


def test_flags_are_the_scripts():
    flags = _script_flags()
    got = vars(celeba_study.get_args([]))
    assert set(got) == set(flags) | set(PORT_ONLY)
    for dest, default in flags.items():
        if dest not in CARD_DEFAULTS:
            assert got[dest] == default, dest
    assert got["retry_wait"] == 5.0
    assert Path(got["workdir"]) == Path(celeba_study.REPO) / "build" / \
        "celeba_study"
    assert Path(got["out"]) == Path(celeba_study.RESULTS) / \
        "celeba_study.json"
    args = celeba_study.get_args(["--seed", "2", "3", "--bf16",
                                  "--train_trunk", "--tag", "_t"])
    assert args.seeds == [2, 3]
    assert Path(args.out).name == "celeba_study_t.json"
    argv = celeba_study.train_argv(args, "C", 3)
    assert argv[1:3] == ["-m", "cdgvae_torch.cli.celeba_main"]
    assert {"--bf16", "--train_trunk"} <= set(argv)
    assert argv[argv.index("--seed") + 1] == "3"
    assert argv[argv.index("--data_dir") + 1] == "C"
    args = celeba_study.get_args(["--platform", "CPU"])
    assert args.device == "cpu"
    argv = celeba_study.train_argv(args, "C", 1)
    assert argv[argv.index("--device") + 1] == "cpu"
    assert "--platform" not in argv
    assert celeba_study.get_args(["--platform", "gpu"]).device == "cuda"


def test_merge_summaries_joins_the_seeds(tmp_path):
    def run(seeds, diag):
        per_seed = [{"seed": s, "nodes": ["a", "b"],
                     "latent_attr_corr_diag": diag,
                     "latent_attr_corr_max_offdiag": [0.1, 0.2],
                     "do_leakage_outside_masks": [0.0, 0.0]} for s in seeds]
        protocol = {"n_train": 8, "seeds": seeds, "lambda": 2000.0}
        return celeba_study.summarize(protocol, per_seed,
                                      {"device": "d", "card": "c"})

    paths = []
    for seeds, diag in (([1], [0.5, 0.9]), ([2, 3], [0.7, 0.9])):
        paths.append(tmp_path / f"{seeds[0]}.json")
        paths[-1].write_text(__import__("json").dumps(run(seeds, diag)))
    merged = celeba_study.merge_summaries(paths, str(tmp_path / "m.json"))
    assert merged == run([1, 2, 3], [0.5, 0.9]) | {
        "per_seed": merged["per_seed"],
        "diag_mean": [round((0.5 + 1.4) / 3, 3), 0.9],
        "diag_std": merged["diag_std"]}
    assert merged["protocol"]["seeds"] == [1, 2, 3]
    assert [s["seed"] for s in merged["per_seed"]] == [1, 2, 3]
    assert (tmp_path / "m.json").is_file()
    with pytest.raises(ValueError, match="repeats"):
        celeba_study.merge_summaries([paths[0], paths[0]],
                                     str(tmp_path / "x.json"))
