"""The manifest against the benchmark's contract, and its files found by
name: a configuration, a traffic mix and a metric added as files."""
import json
import re
import shutil

from benchmark.manifest import ROOT, Cell, load_module

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_manifest_keeps_the_contract():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["benchmark"] and 1 <= m["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w
               for w in m["command"])
    names = [c["name"] for c in m["configs"]] \
        + [w["name"] for w in m["workloads"]] \
        + [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert all(NAME.match(n) for n in names)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25 and x["source"] == "host_clock"
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    for x in m["per_layer"]:
        assert x["moves"] in e2e
        assert set(x) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] == 1 for w in m["workloads"])


def test_every_cell_finds_its_files():
    for w in manifest()["workloads"]:
        cell = Cell(w["name"])
        module = cell.module()
        assert hasattr(module, "Session")
        assert hasattr(module, "products_per_step")
        assert cell.limits, f"{w['name']} has no limits file"
        assert cell.end_to_end and cell.per_layer
        for m in cell.per_layer:
            assert callable(cell.metric(m["name"]).read)
        for key in ("feed", "dtype", "warmup_epochs", "trace_epochs"):
            assert key in cell.traffic
        entry = {c["name"]: c for c in manifest()["configs"]}[w["config"]]
        for key in entry["reduced"]:
            assert key in cell.config


def test_added_files_are_found_without_editing_the_harness(tmp_path):
    here = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = manifest()
    (here / "configs" / "toy.json").write_text(json.dumps(
        {"name": "toy", "batch_size": 4, "image_size": 2}))
    (here / "configs" / "toy.py").write_text(
        "class Session:\n    pass\n\n\n"
        "def products_per_step(cfg, traffic):\n"
        "    return {'flops': 2 * cfg['batch_size'], 'gemm': [(8, 8)]}\n")
    (here / "traffic" / "toy-mix.json").write_text(json.dumps(
        {"feed": "fixed", "dtype": "float32", "warmup_epochs": 1,
         "trace_epochs": 1}))
    (here / "metrics" / "toy_metric.py").write_text(
        "UNIT = 'x'\n\n\ndef read(ctx):\n    return None\n")
    m["configs"].append({"name": "toy", "source": "a paper",
                         "file": "benchmark/configs/toy.json",
                         "reduced": [], "why": "test"})
    m["workloads"].append({"name": "toy.mix", "config": "toy",
                           "traffic": "toy-mix", "chips": 1, "why": "t"})
    m["per_layer"].append({"name": "toy_metric", "unit": "x",
                           "better": "lower", "source": "program_counter",
                           "layer": "test", "moves": "train_images_per_s",
                           "workloads": ["toy.mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    cell = Cell("toy.mix", here=here)
    assert cell.config["batch_size"] == 4
    assert cell.traffic["feed"] == "fixed"
    assert cell.module().products_per_step(cell.config, cell.traffic)[
        "flops"] == 8
    assert [x["name"] for x in cell.per_layer if x["name"] == "toy_metric"]
    assert cell.metric("toy_metric").read(None) is None
    # the cells already there still find theirs
    assert Cell("pendulum-cdgvae.fixed", here=here).config["node"] == 4


def test_the_sizes_of_the_configurations_are_published_ones():
    pend = Cell("pendulum-cdgvae.fixed").config
    assert (pend["image_size"], pend["hidden"], pend["batch_size"],
            pend["node"], pend["factor"]) == (64, 300, 128, 4, [1, 1, 2])
    celeba = Cell("celeba-cdgvae.f32").config
    assert (celeba["img_size"], celeba["conv_dim"], celeba["batch_size"],
            celeba["node"], celeba["latent_dim"]) == (128, 32, 16, 6, 6)
    ref = load_module(ROOT / "benchmark" / "configs"
                      / "celeba-cdgvae.reference.py")
    n = sum(__import__("math").prod(s[1])
            for s in ref.weight_specs(celeba) if not s[0].endswith(
                (".u", ".v")))
    assert 48e6 < n < 50e6  # the 49M-parameter CelebA CDG-VAE
