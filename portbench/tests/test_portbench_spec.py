"""The benchmark's files parse and agree with each other and with the
contract's shapes: every cell's configuration, traffic, limits and
metrics, every per-layer metric's reader, the kernel classes."""

import json
import re

import pytest

from portbench import reference as ref
from portbench import spec, trace

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parses(cell):
    w, conf, traffic = spec.cell(BENCH, cell)
    assert NAME.match(cell) and len(w["why"]) <= 200
    assert w["chips"] == 1
    assert traffic["kind"] in ("train", "iw_eval")
    shapes = ref.param_shapes(conf["config"])
    assert sum(int(__import__("math").prod(s)) for s in shapes.values()) \
        == conf["params"]
    assert json.loads((spec.HERE / "limits" / f"{cell}.json").read_text())[
        "limits"]
    e2e = [m["name"] for m in spec.metrics(BENCH, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = spec.metrics(BENCH, cell, True)
    assert layer and all(m["moves"] in e2e for m in layer)


def test_configs_are_their_files():
    for c in BENCH["configs"]:
        data = json.loads((spec.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        assert NAME.match(c["name"]) and len(c["why"]) <= 200


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert callable(spec.reader(m["name"]))
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_kernel_classes():
    order, table = trace.classes()
    assert set(order) == set(table)
    assert trace.classify("void ar_stack_wgmma_kernel<160, false, true>("
                          "StackArgs, int, int, int)") == "k1"
    assert trace.classify("void conv_wgmma_kernel<160, __nv_bfloat16, 2>("
                          "ConvArgs, int, int, int)") == "k2"
    assert trace.classify("adamax_kernel") == "k5"
    assert trace.classify("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_"
                          "f32_nhwckrsc_nhwc_tilesize128x128x64") == "cudnn"
    assert trace.classify("Memset (Unknown)") == "memory"
    assert trace.classify("void at::native::vectorized_elementwise_kernel<4,"
                          " at::native::CUDAFunctor_add<float>>") \
        == "elementwise"


def test_union_and_gaps():
    t = trace.Trace([("a", "k1", 0.0, 1.0), ("b", "k2", 0.5, 2.0),
                     ("c", "cudnn", 3.0, 4.0)], 5.0,
                    [("feed", 2.0, 2.9), ("step", 0.0, 4.0)])
    assert t.busy_s() == pytest.approx(3.0)
    assert t.class_s("k1", "k2") == pytest.approx(2.5)
    assert dict(t.idle_gaps()) == pytest.approx({"feed": 1.0,
                                                 "untraced host work": 1.0})
