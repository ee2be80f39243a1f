"""BENCHMARK.json against the characters its names and units may use, and the files the
harness finds by name."""
import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
ROOT = REPO / "portbench"
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _names():
    out = []
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        out += [(sec, e["name"]) for e in BENCH[sec]]
    out += [("config", w["config"]) for w in BENCH["workloads"]]
    out += [("traffic", w["traffic"]) for w in BENCH["workloads"]]
    out += [("reduced", k) for c in BENCH["configs"] for k in c["reduced"]]
    return out


@pytest.mark.parametrize("kind,name", _names())
def test_name_characters(kind, name):
    assert NAME.match(name), (kind, name)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert (ROOT / "metrics" / f"{metric['name']}.py").exists()
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert metric["layer"] and "\n" not in metric["layer"]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(cell):
    assert len(cell["why"]) <= 200 and cell["chips"] in (1, 4)
    assert (ROOT / "traffic" / f"{cell['traffic']}.json").exists()
    assert (ROOT / "limits" / f"{cell['name']}.json").exists()
    conf = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    data = json.loads((REPO / conf["file"]).read_text())
    assert (ROOT / "reference" / f"{data['reference']}.py").exists()
    for k in data.get("kernels", []):
        assert (ROOT / "roofline" / f"{k}.py").exists()
    e2e = [m for m in BENCH["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    assert {"setup_s"} < {m["name"] for m in e2e}


QWEN2 = {"n_layers": "num_hidden_layers", "d_model": "hidden_size",
         "n_heads": "num_attention_heads",
         "n_kv_heads": "num_key_value_heads", "d_ff": "intermediate_size",
         "vocab_size": "vocab_size", "norm_eps": "rms_norm_eps",
         "rope_theta": "rope_theta"}


def test_qwen2_file_matches_its_port_section():
    data = json.loads((ROOT / "configs" / "qwen2-7b.json").read_text())
    p = data["port"]
    for port_key, key in QWEN2.items():
        assert p[port_key] == data[key], port_key
    assert p["tie_embeddings"] == data["tie_word_embeddings"]
    assert p["qkv_bias"] and not data["use_sliding_window"]


def test_mamba2_file_matches_its_port_section():
    data = json.loads((ROOT / "configs" / "mamba2-1.3b.json").read_text())
    p, m = data["port"], data["mamba2_defaults"]
    assert p["n_layers"] == data["n_layer"]
    assert p["d_model"] == data["d_model"]
    assert p["d_ff"] == data["d_intermediate"] == 0
    assert p["tie_embeddings"] == data["tie_embeddings"]
    pad = data["pad_vocab_size_multiple"]
    assert p["vocab_size"] == -(-data["vocab_size"] // pad) * pad
    assert p["norm_eps"] == m["norm_epsilon"]
    s = p["ssm"]
    assert (s["state_dim"], s["conv_width"], s["expand"], s["head_dim"],
            s["n_groups"]) == (m["d_state"], m["d_conv"], m["expand"],
                               m["headdim"], m["ngroups"])
    assert p["n_heads"] == s["expand"] * p["d_model"] // s["head_dim"]


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_published_and_uncut(conf):
    data = json.loads((REPO / conf["file"]).read_text())
    assert conf["reduced"] == []
    assert data["source"] == conf["source"]


def test_command_and_paths():
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")
    assert 1 <= BENCH["run_seconds"] <= 51
