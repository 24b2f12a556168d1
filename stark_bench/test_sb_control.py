"""The comparison that decides ``correct`` has to fail: a run of a tiny
cell on the CPU (the harness's look for a card skipped) with the timed
path broken underneath comes out not correct, for the control (the
configuration's control options: one bit less of proof of work) and for
each fault a proof can have: a byte altered where the proof is made, a
prove that fails, and a witness altered in the entry layer.  A sound run
of the same cell is correct.  On a card, the control at a cell's own
size."""

import json
import os
import shutil
import sys
import time

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import harness  # noqa: E402

ROOT = os.path.dirname(HERE)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A copy of the checkout whose cells are the configurations' at 2^7
    rows (fib) and at a 32-cycle program (brainfuck, two bits of proof of
    work)."""
    root = tmp_path_factory.mktemp("ck")
    shutil.copytree(HERE, root / "stark_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    os.symlink(os.path.join(ROOT, "ministark_tpu_torch"),
               root / "ministark_tpu_torch")
    sb = root / "stark_bench"
    cfg = json.loads((sb / "configs" / "brainfuck.json").read_text())
    cfg["name"] = "brainfuck_g2"
    cfg["options"]["grinding_factor"] = 2
    cfg["control"]["options"]["grinding_factor"] = 1
    (sb / "configs" / "brainfuck_g2.json").write_text(json.dumps(cfg))
    (sb / "traffic" / "rows2e7.json").write_text(json.dumps({"rows": 128}))
    (sb / "traffic" / "bf32.json").write_text(json.dumps(
        {"program": "++[>+<-]>.", "input": "", "rows": 32}))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "brainfuck_g2", "source": "test",
                         "file": "stark_bench/configs/brainfuck_g2.json",
                         "reduced": [], "why": "test"})
    b["workloads"] += [
        {"name": "fib.rows2e7", "config": "fib", "traffic": "rows2e7",
         "chips": 1, "why": "test"},
        {"name": "bf.bf32", "config": "brainfuck_g2", "traffic": "bf32",
         "chips": 1, "why": "test"}]
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return str(root)


CELLS = ["fib.rows2e7", "bf.bf32"]


def run(root, name, **kw):
    cell = harness.load_cell(name, root)
    return harness.run_cell(cell, 0.2, False, time.perf_counter(),
                            device="cpu", **kw)


def flagged(r):
    return {k for k, c in r["checks"].items() if c["value"] > c["limit"]}


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny, name):
    r = run(tiny, name)
    assert r["correct"] and not flagged(r)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(tiny, name):
    cell = harness.load_cell(name, tiny)
    opts = dict(cell.config["options"], **cell.config["control"]["options"])
    r = run(tiny, name, options=opts)
    assert not r["correct"]
    assert r["checks"]["bytes"]["value"] == r["attempted"]


def _flip(prove):
    def altered(*a):
        data = bytearray(prove(*a))
        data[-9] ^= 1  # inside the last composition OOD evaluation
        return bytes(data)
    return altered


def _fail_once(prove):
    calls = []

    def failing(*a):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("a prove that fails")
        return prove(*a)
    return failing


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault,caught", [(_flip, "ood"),
                                          (_fail_once, "failed")])
def test_fault_is_not_correct(tiny, name, fault, caught):
    r = run(tiny, name, prove_hook=fault)
    assert not r["correct"] and caught in flagged(r)


@pytest.mark.parametrize("name", CELLS)
def test_altered_witness_is_not_correct(tiny, name, monkeypatch):
    load = harness.load_air

    def altered_air(config, root):
        air = load(config, root)
        make = air.program

        def program(config, traffic, device):
            claim, witness, opts, fq = make(config, traffic, device)
            witness.base_columns().values[3, 5] += 1  # one trace value
            return claim, witness, opts, fq
        air.program = program
        return air

    monkeypatch.setattr(harness, "load_air", altered_air)
    r = run(tiny, name)
    assert not r["correct"] and "base_root" in flagged(r)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control at a cell's size")


@pytest.mark.parametrize("name", ["fib.rows2e22", "bf.fibonacci10"])
def test_control_at_cell_size_on_card(card, name):
    import control

    assert control.main(["--workload", name, "--seeds", "1,2,3",
                         "--seconds", "2"]) == 0
