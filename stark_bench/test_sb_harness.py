"""The harness's own logic, on the CPU: loading cells, configurations,
traffic mixes and metrics by name, the refusal of a traffic setting the
harness does not carry out, the window arithmetic, the interval union,
the split between hand-written kernels and the libraries' operations,
the check for JAX, the contract's shape of BENCHMARK.json, and a cell,
configuration, traffic mix and metric added by new files and entries
alone (in a temporary copy), on one process and over ranks."""

import json
import os
import re
import shutil
import sys
import time

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import harness  # noqa: E402
import own_kernels  # noqa: E402

ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return harness.load_benchmark(ROOT)


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_loads_by_name(cell):
    c = harness.load_cell(cell, ROOT)
    assert c.config["options"] and c.traffic
    air = harness.load_air(c.config, ROOT)
    assert callable(air.program) and callable(air.reference)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(harness.load_metric(m["name"], ROOT).read)


def test_every_metric_file_is_named():
    named = {m["name"] for m in bench()["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(HERE, "metrics"))
             if f.endswith(".py")}
    assert files == named


def test_benchmark_json_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["stark_bench"]
    assert 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) <= 64 * 1024
    names = [c["name"] for c in b["configs"]] + [
        w["name"] for w in b["workloads"]] + [
        m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("stark_bench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(HERE, "traffic",
                                           w["traffic"] + ".json"))
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in e2e
    for m in b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_window_arithmetic():
    assert harness.mean_prove_s(10.0, 4) == 2.5
    lat = [float(i) for i in range(1, 201)]
    assert harness.nearest_rank(lat, 0.95) == 190.0
    assert harness.nearest_rank(list(reversed(lat)), 0.95) == 190.0
    assert harness.nearest_rank([3.0], 0.95) == 3.0
    assert harness.nearest_rank([1.0, 2.0], 0.95) == 2.0


def test_phase_mean_ms():
    r = harness.Readings({})
    r.phases = [[{"phase": "A", "host_ms": 9.0, "device_ms": 2.0}],
                [{"phase": "A", "host_ms": 9.0, "device_ms": 4.0},
                 {"phase": "B", "host_ms": 5.0, "device_ms": None}]]
    assert harness.phase_mean_ms(r, "A") == 3.0
    assert harness.phase_mean_ms(r, "B") == 5.0
    assert harness.phase_mean_ms(r, "C") is None


def test_interval_union_and_gaps():
    iv = [(5, 7), (0, 2), (1, 3), (6, 6.5), (10, 11)]
    assert harness.interval_union(iv) == 3 + 2 + 1
    assert harness.interval_union([]) == 0
    assert harness.gaps(iv, 0, 12) == [(3, 5), (7, 10), (11, 12)]
    assert harness.gaps(iv, -1, 4) == [(-1, 0), (3, 4)]
    assert harness.gaps([], 0, 1) == [(0, 1)]


def _globals(text: str) -> list:
    """The names of the ``__global__`` functions in CUDA source `text`."""
    return re.findall(r"__global__\s+(?:static\s+)?void\s+(?:__launch_bounds__"
                      r"\s*\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(", text)


def test_every_program_kernel_is_counted_as_hand_written():
    pkg = os.path.join(ROOT, "ministark_tpu_torch")
    csrc = os.path.join(pkg, "csrc")
    sources = [os.path.join(csrc, f) for f in sorted(os.listdir(csrc))
               if f.endswith((".cu", ".cuh"))]
    sources.append(os.path.join(pkg, "ops", "eval.py"))
    names = []
    for path in sources:
        with open(path) as f:
            text = f.read()
        found = _globals(text)
        assert len(found) == text.count("__global__"), path
        names += found
    assert {"transpose_tiles_kernel", "transpose_kernel", "col_ntt_kernel",
            "hash_rows_kernel", "ms_eval_group_kernel"} <= set(names)
    for n in names:
        # as the profiler names a kernel: return type, template arguments
        # and parameters
        for shown in (n, f"{n}(unsigned long const*, long)",
                      f"void {n}<12>(unsigned long const*, unsigned long*)"):
            assert own_kernels.is_own(shown), shown


@pytest.mark.parametrize("name", [
    "void at::native::vectorized_elementwise_kernel<2, at::native::"
    "CUDAFunctor_add<long>, std::array<char*, 3ul> >(int, at::native::"
    "CUDAFunctor_add<long>, std::array<char*, 3ul>)",
    "void at::native::(anonymous namespace)::indexSelectLargeIndex<long, "
    "long, unsigned int, 2, 2, -2, true>(at::cuda::detail::TensorInfo)",
    "void at_cuda_detail::cub::DeviceScanKernel<at_cuda_detail::cub::"
    "DeviceScanPolicy<long>::Policy900>(long*)",
    "void thrust::cuda_cub::core::_kernel_agent<thrust::cuda_cub::"
    "__parallel_for::ParallelForAgent>(long)",
    "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
    "Memcpy HtoD (Pageable -> Device)", "Memcpy DtoH (Device -> Pinned)",
    "Memset (Device)"])
def test_library_operations_are_glue(name):
    assert not own_kernels.is_own(name)


def test_traffic_setting_not_carried_out_is_refused(tmp_path):
    root = tmp_path / "ck"
    shutil.copytree(HERE, root / "stark_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    traffic = json.loads((root / "stark_bench" / "traffic" /
                          "rows2e22.json").read_text())
    traffic["clients"] = 4
    (root / "stark_bench" / "traffic" / "rows2e22.json").write_text(
        json.dumps(traffic))
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    with pytest.raises(ValueError, match="clients"):
        harness.load_cell("fib.rows2e22", str(root))


def test_forbidden_modules_compare_whole_names():
    f = harness.forbidden_modules
    assert f({"ministark_tpu_torch": 0, "ministark_tpu_torch.ops": 0,
              "jaxtyping": 0, "flax_like": 0}) == []
    assert f({"ministark_tpu": 0}) == ["ministark_tpu"]
    assert f({"jax.numpy": 0, "jaxlib.xla_client": 0, "flax": 0}) == [
        "flax", "jax", "jaxlib"]


@pytest.fixture
def copy_with_new_cell(tmp_path):
    """A checkout's copy with a new configuration, traffic mix, cell and
    per-layer metric, each added as files and entries only."""
    root = tmp_path / "ck"
    root.mkdir()
    shutil.copytree(HERE, root / "stark_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    os.symlink(os.path.join(ROOT, "ministark_tpu_torch"),
               root / "ministark_tpu_torch")
    sb = root / "stark_bench"
    cfg = json.loads((sb / "configs" / "fib.json").read_text())
    cfg["name"] = "fib_small"
    cfg["options"] = {"num_queries": 8, "lde_blowup_factor": 4,
                      "grinding_factor": 2, "fri_folding_factor": 4,
                      "fri_max_remainder_coeffs": 16}
    (sb / "configs" / "fib_small.json").write_text(json.dumps(cfg))
    (sb / "traffic" / "rows2e7.json").write_text(json.dumps({"rows": 128}))
    (sb / "metrics" / "window.proves.py").write_text(
        "def read(r):\n    return len(r.latencies)\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "fib_small", "source": "test",
                         "file": "stark_bench/configs/fib_small.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "fib_small.rows2e7", "config":
                           "fib_small", "traffic": "rows2e7", "chips": 1,
                           "why": "test"})
    b["per_layer"].append({"name": "window.proves", "unit": "proves",
                           "better": "higher", "source": "host_clock",
                           "layer": "entry", "moves": "prove_s",
                           "workloads": ["fib_small.rows2e7"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return str(root)


def test_new_cell_by_files_and_entries(copy_with_new_cell):
    cell = harness.load_cell("fib_small.rows2e7", copy_with_new_cell)
    r = harness.run_cell(cell, 0.5, True, time.perf_counter(), device="cpu")
    assert r["correct"], r["checks"]
    assert r["metrics"]["window.proves"]["value"] == r["_window"]["proves"]
    assert r["metrics"]["phase_ms.constraint_eval"]["value"] > 0
    assert "phase_ms.ext_commit" not in r["metrics"]
    assert list(r)[-3] == "checks"  # the compared numbers come last
    r = harness.run_cell(cell, 0.5, False, time.perf_counter(),
                         device="cpu")
    assert set(r["metrics"]) == {"prove_s", "peak_device_gib", "setup_s"}


@pytest.fixture
def copy_with_ranks_cell(copy_with_new_cell):
    """The copy above with a cell over two ranks and the parallel layer's
    metrics, again files and entries only."""
    root = copy_with_new_cell
    metrics = os.path.join(root, "stark_bench", "metrics")
    with open(os.path.join(metrics, "parallel.collectives.py"), "w") as f:
        f.write("def read(r):\n    if r.collectives is None:\n"
                "        return None\n"
                "    return r.collectives / len(r.latencies)\n")
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        b = json.load(f)
    b["workloads"].append({"name": "fib_small.rows2e7.ranks2",
                           "config": "fib_small", "traffic": "rows2e7",
                           "chips": 2, "why": "test"})
    b["per_layer"].append({"name": "parallel.collectives",
                           "unit": "collectives", "better": "lower",
                           "source": "program_counter", "layer": "parallel",
                           "moves": "prove_s",
                           "workloads": ["fib_small.rows2e7.ranks2"]})
    b["per_layer"][-2]["workloads"].append("fib_small.rows2e7.ranks2")
    with open(path, "w") as f:
        json.dump(b, f)
    return root


def test_cell_over_ranks(copy_with_ranks_cell):
    """Two gloo ranks on the CPU prove in step with ``prove_sharded``;
    rank 0's proofs equal the reference's, and its counters are read."""
    cell = harness.load_cell("fib_small.rows2e7.ranks2",
                             copy_with_ranks_cell)
    assert cell.chips == 2
    t0 = time.perf_counter()
    r = harness.run_cell(cell, 0.5, True, t0, device="cpu")
    assert r["correct"], r["checks"]
    assert r["device"]["count"] == 2 and r["_forbidden"] == []
    proves = r["metrics"]["window.proves"]["value"]
    assert proves == r["_window"]["proves"] >= 1
    assert r["attempted"] == proves + 2  # a cold and a warm prove before
    assert r["metrics"]["parallel.collectives"]["value"] > 0
    r = harness.run_cell(cell, 0.5, False, time.perf_counter(),
                         device="cpu")
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"prove_s", "peak_device_gib", "setup_s"}
    assert 0 < r["metrics"]["setup_s"]["value"]
