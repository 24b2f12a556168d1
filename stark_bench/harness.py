"""The benchmark of ``ministark_tpu_torch``: one cell a run, driven by data.

A cell of ``BENCHMARK.json`` names a configuration (its entry there gives
the file, ``configs/<name>.json``), a traffic mix (``traffic/<name>.json``)
and its chips.  The configuration's ``air`` names the module under
``airs/`` that makes the measured program's claim and witness through the
program's own entry points, and the plain reference's proof.  Each
per-layer metric is read by ``metrics/<metric name>.py``.  A later cell,
configuration, traffic mix or metric is new files and entries, and no
edit here.

A run: make the witness (the entry layer), prove once cold (the first run
in a checkout builds the kernels into the program's build directory
there) and once warm, reset the peak-memory statistics and the kernel
counters, then prove back to back in a closed loop, one client, each
prove ending with the proof's bytes on the host, until ``--seconds`` have
passed; the window ends with the last prove.  A cell on one card proves
with ``Stark.prove`` in this process; a cell on several runs one rank a
card (``parallel.spawn.RankPool`` over NCCL), every rank doing all of
that with ``parallel.prover.prove_sharded``, and rank 0's clock closes
the window.  The process is left at its defaults: its threads and its
garbage collector are the program's.  With ``--trace 1`` a few more
proves run under ``torch.profiler`` after the window.  Then the program's
state is freed, the plain reference proves the same claim on the first
card, and every proof of the run is compared with it, section by
section.  The last line of standard output is the result.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "ministark_tpu")
# seconds the profiled proves of a traced run add up to at least
PROFILE_S = 0.5
PROFILE_MAX = 8


# -- the benchmark's data -----------------------------------------------------

@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list
    root: str = ROOT


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of the benchmark at `root`, with its configuration,
    traffic mix and the metrics it reports.  A traffic file may hold only
    ``what`` (its description) and the keys its AIR reads (the AIR
    module's ``TRAFFIC``): a setting the harness does not carry out is
    refused, not measured as something else."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({sorted(cells)})")
    w = cells[name]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = _load_json(os.path.join(root, cfg["file"]))
    traffic = _load_json(os.path.join(root, "stark_bench", "traffic",
                                      w["traffic"] + ".json"))
    unknown = set(traffic) - {"what"} - set(load_air(config, root).TRAFFIC)
    if unknown:
        raise ValueError(f"traffic {w['traffic']!r}: the harness does not "
                         f"carry out {sorted(unknown)}")
    return Cell(name=name, config=config, traffic=traffic,
                chips=w["chips"],
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)],
                root=root)


def _load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_air(config: dict, root: str = ROOT):
    """The module of the configuration's AIR (``airs/<air>.py``)."""
    return _load_module(os.path.join(root, "stark_bench", "airs",
                                     config["air"] + ".py"),
                        "sb_air_" + config["air"])


def load_metric(name: str, root: str = ROOT):
    """The reader of per-layer metric `name` (``metrics/<name>.py``): its
    ``read(readings)`` gives a number, or None where it finds nothing."""
    return _load_module(os.path.join(root, "stark_bench", "metrics",
                                     name + ".py"),
                        "sb_metric_" + name.replace(".", "_"))


# -- what a run reads ---------------------------------------------------------

@dataclass
class Readings:
    """What the metric readers read: the cell's configuration, the
    window's latencies and phase records, the entry layer's seconds, the
    kernel launches counted over the window, over several cards rank 0's
    collectives and the bytes it sent in them over the window, and
    (traced runs) the profiler's summary."""
    config: dict
    latencies: list = field(default_factory=list)
    window_s: float = 0.0
    entry_s: float = 0.0
    phases: list = field(default_factory=list)
    launches: int | None = None
    collectives: int | None = None
    collective_bytes: int | None = None
    profile: dict | None = None


def mean_prove_s(window_s: float, proves: int) -> float:
    """The window's wall time over the proves completed in it."""
    return window_s / proves


def nearest_rank(values: list, q: float) -> float:
    """The q-quantile of `values` by the nearest rank: the smallest value
    with at least q of all the values at or below it."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def phase_mean_ms(readings: Readings, phase: str) -> float | None:
    """A phase's device ms, the mean over the window's proves."""
    vals = [p["device_ms"] if p["device_ms"] is not None else p["host_ms"]
            for log in readings.phases for p in log if p["phase"] == phase]
    return sum(vals) / len(vals) if vals else None


def interval_union(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals, start: float, stop: float) -> list:
    """The (start, end) stretches of [start, stop] that no interval
    covers."""
    out, cur = [], start
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, stop)))
        cur = max(cur, e)
        if cur >= stop:
            break
    if cur < stop:
        out.append((cur, stop))
    return [(a, b) for a, b in out if b > a]


def forbidden_modules(modules=None) -> list:
    """Top-level names in `modules` (sys.modules) that no run may load,
    each compared whole: ``ministark_tpu_torch`` is not ``ministark_tpu``."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


# -- the comparison that decides `correct` ------------------------------------

SECTIONS = ("bytes", "base_root", "ext_root", "comp_root", "ood",
            "fri_roots", "fri_remainder", "queries", "pow_nonce")


def sections(data: bytes, fp, fq) -> dict:
    """A proof's bytes split into what each layer put into it, read by the
    reference's own parser."""
    from plainstark import serde
    from plainstark.proof import Proof

    p = Proof.from_bytes(data, fp, fq)

    def ser(fn):
        w = serde.Writer()
        fn(w)
        return w.bytes()

    fri = p.fri_proof
    return {
        "bytes": data,
        "base_root": p.base_trace_commitment,
        "ext_root": p.extension_trace_commitment,
        "comp_root": p.composition_trace_commitment,
        "ood": ser(lambda w: (w.field_vec(p.execution_trace_ood_evals),
                              w.field_vec(p.composition_trace_ood_evals))),
        "fri_roots": b"".join(layer.commitment for layer in fri.layers),
        "fri_remainder": ser(lambda w: w.field_vec(fri.remainder_coeffs)),
        "queries": ser(lambda w: (p.trace_queries.serialize(w, fq), [
            (w.field_vec(layer.flattened_rows),
             layer.merkle_proof.serialize(w)) for layer in fri.layers])),
        "pow_nonce": p.pow_nonce,
    }


def compare(proofs: list, reference: bytes, fq_ext: bool) -> dict:
    """For each section, the number of `proofs` (bytes) whose section
    differs from the reference's; a proof the parser rejects differs in
    every section."""
    from plainstark.fields.scalar import Fp, Fq3

    fq = Fq3 if fq_ext else Fp
    ref = sections(reference, Fp, fq)
    counts = dict.fromkeys(SECTIONS, 0)
    memo: dict = {}
    for data in proofs:
        if data not in memo:
            try:
                got = sections(data, Fp, fq)
                memo[data] = [k for k in SECTIONS if got[k] != ref[k]]
            except Exception:  # noqa: BLE001 - malformed bytes differ
                memo[data] = list(SECTIONS)
        for k in memo[data]:
            counts[k] += 1
    return counts


# -- the run ------------------------------------------------------------------

# seconds the ranks of a cell over several cards may take to start, to run
# (the first run in a checkout compiles) and to wait in a collective
RANK_TIMEOUT = 1100


class _PhaseMarks(list):
    """A phase log that marks each phase's end in the profiler's timeline
    (the program appends a phase's record as the phase ends)."""

    def append(self, rec):
        import torch

        with torch.profiler.record_function("sb.phase:" + rec["phase"]):
            pass
        super().append(rec)


def _reset_counters(build):
    for k in build.KERNELS.values():
        k.launches = 0


def _summarise_profile(prof, proves: int) -> dict:
    """Device time by operation, the union of the device intervals, the
    split between hand-written kernels and the libraries' operations, and
    the idle time by the phase the host was in, over the profiled
    window."""
    from own_kernels import is_own

    events = list(prof.events())
    window = next(e for e in events if e.name == "sb.window")
    w0, w1 = window.time_range.start, window.time_range.end
    # ranges (the harness's own, NCCL's "nccl:*") also show on the device's
    # timeline; they are no device operations
    dev = [e for e in events if e.device_type.name == "CUDA"
           and not e.name.startswith("sb.")
           and not getattr(e, "is_user_annotation", False)
           and e.time_range.end > w0 and e.time_range.start < w1]
    intervals = [(max(e.time_range.start, w0), min(e.time_range.end, w1))
                 for e in dev]
    ops: dict = {}
    own = plain = 0.0
    for e, (s, t) in zip(dev, intervals):
        d = (t - s) / 1e6
        ops[e.name] = ops.get(e.name, 0.0) + d
        if is_own(e.name):
            own += d
        else:
            plain += d
    marks = sorted((e.time_range.start, e.name[len("sb.phase:"):])
                   for e in events if e.name.startswith("sb.phase:")
                   and w0 <= e.time_range.start <= w1)
    idle: dict = {}
    for a, b in gaps(intervals, w0, w1):
        mid = (a + b) / 2
        phase = next((name for t, name in marks if t >= mid),
                     "after the last phase")
        idle[phase] = idle.get(phase, 0.0) + (b - a) / 1e6
    return {"proves": proves, "wall_s": (w1 - w0) / 1e6,
            "busy_s": interval_union(intervals) / 1e6, "own_s": own,
            "plain_s": plain, "ops": ops, "idle_by_phase": idle}


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def log(*args):
    print(*args, file=sys.stderr, flush=True)


@dataclass
class Window:
    """One process's part of a run: its readings, the digest of each
    proof it made in order (rank 0's alone over several cards) with each
    distinct proof's bytes, the proves attempted and failed, the cold
    prove's seconds, the window's start on the host's monotonic clock
    (``time.perf_counter``, which every process of the host shares), the
    peak device memory, the forbidden modules it loaded, and whether the
    proof is over the cubic extension."""
    readings: Readings
    proofs: list
    distinct: dict
    attempted: int
    failed: int
    cold_s: float
    start: float
    peak: int
    found: list
    ext3: bool


def _measure(cell: Cell, seconds: float, trace: bool, device,
             prove_hook=None, options: dict | None = None,
             mesh=None) -> Window:
    """Set-up and the measured window in this process: the whole prove,
    or, given `mesh`, this rank's part of ``prove_sharded``, every rank
    proving in step and rank 0's clock closing the window."""
    os.environ["MINISTARK_TPU_TIMERS"] = "0"
    if cell.root not in sys.path:
        sys.path.insert(1, cell.root)
    import torch

    from ministark_tpu_torch.ops import build

    cuda = torch.device(device).type == "cuda"
    lead = mesh is None or mesh.rank == 0

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def rank0(value: int) -> int:
        """Rank 0's `value` on every rank."""
        if mesh is None:
            return value
        import torch.distributed as dist

        t = torch.tensor([value], dtype=torch.int64, device=mesh.device)
        dist.broadcast(t, 0, group=mesh.group)
        return int(t.item())

    air = load_air(cell.config, cell.root)
    rd = Readings(cell.config)

    t0 = time.perf_counter()
    claim, witness, opts, fq = air.program(cell.config, cell.traffic, device)
    sync()
    rd.entry_s = time.perf_counter() - t0
    if options is not None:
        opts = type(opts)(**options)

    if mesh is None:
        def prove(phase_log):
            return claim.prove(opts, witness, phase_log).to_bytes(fq)
    else:
        from ministark_tpu_torch.parallel.prover import prove_sharded

        def prove(phase_log):
            proof = prove_sharded(claim, opts, witness, mesh,
                                  phase_log=phase_log)
            return proof.to_bytes(fq) if lead else None

    if prove_hook is not None:
        prove = prove_hook(prove)

    proofs: list = []    # each prove's digest, in order
    distinct: dict = {}  # digest -> the proof's bytes
    attempted = failed = 0

    def attempt(phase_log):
        nonlocal attempted, failed
        attempted += 1
        try:
            data = prove(phase_log)
        except Exception as e:  # noqa: BLE001 - a failed prove is counted
            if mesh is not None:  # the ranks are out of step: no run
                raise
            failed += 1
            log(f"prove failed: {type(e).__name__}: {e}")
            return False
        if data is not None:
            digest = hashlib.sha256(data).digest()
            distinct.setdefault(digest, data)
            proofs.append(digest)
        return True

    t0 = time.perf_counter()
    attempt([])
    sync()
    cold_s = time.perf_counter() - t0
    attempt([])
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _reset_counters(build)
    if mesh is not None:
        mesh.reset_stats()
        rank0(0)  # the ranks open the window together
    start = time.perf_counter()
    if lead:
        log(f"{cell.name}: entry {rd.entry_s:.3f} s, cold prove "
            f"{cold_s:.3f} s")

    while True:
        phases: list = []
        t0 = time.perf_counter()
        ok = attempt(phases)
        sync()
        end = time.perf_counter()
        if ok:
            rd.latencies.append(end - t0)
            rd.phases.append(phases)
        if rank0(int(end - start >= seconds)):
            break
    rd.window_s = end - start
    rd.launches = sum(k.launches for k in build.KERNELS.values())
    if mesh is not None:
        rd.collectives = mesh.collectives
        rd.collective_bytes = mesh.collective_bytes
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    if trace and cuda and rd.latencies:
        from torch.profiler import ProfilerActivity, profile

        k = rank0(max(1, min(PROFILE_MAX, math.ceil(
            PROFILE_S / (sum(rd.latencies) / len(rd.latencies))))))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function("sb.window"):
                for _ in range(k):
                    attempt(_PhaseMarks())
                sync()
        rd.profile = _summarise_profile(prof, k)
        del prof

    found = forbidden_modules({m: v for m, v in sys.modules.items()
                               if v is not None})
    del claim, witness
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return Window(rd, proofs, distinct, attempted, failed, cold_s, start,
                  int(peak), found, fq.__name__ == "Fq3")


def _rank_measure(mesh, root: str, name: str, seconds: float,
                  trace: bool) -> Window:
    """Run on every rank of a cell over several cards (``RankPool``)."""
    return _measure(load_cell(name, root), seconds, trace, mesh.device,
                    mesh=mesh)


def _measure_ranks(cell: Cell, seconds: float, trace: bool,
                   device) -> Window:
    """The window of a cell over ``cell.chips`` ranks, one a card over
    NCCL (over gloo on the CPU, for the tests): rank 0's proofs, latencies
    and counters, the fullest card's peak, every rank's forbidden modules,
    and the profiled device time averaged over the ranks."""
    if cell.root not in sys.path:
        sys.path.insert(1, cell.root)
    import torch

    from ministark_tpu_torch.parallel.spawn import RankPool

    cuda = torch.device(device).type == "cuda"
    with RankPool(cell.chips, "nccl" if cuda else "gloo", device,
                  timeout=RANK_TIMEOUT) as pool:
        wins = pool.run(_rank_measure, cell.root, cell.name, seconds, trace)
    w = wins[0]
    w.peak = max(x.peak for x in wins)
    w.found = sorted(set().union(*(x.found for x in wins)))
    if w.readings.profile is not None:
        for key in ("busy_s", "wall_s", "own_s", "plain_s"):
            w.readings.profile[key] = sum(
                x.readings.profile[key] for x in wins) / len(wins)
    return w


def _tenths(values: list) -> list:
    n = len(values)
    parts = [values[i * n // 10:(i + 1) * n // 10] for i in range(10)]
    return [sum(p) / len(p) for p in parts if p]


def run_cell(cell: Cell, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", prove_hook=None,
             options: dict | None = None) -> dict:
    """One run of `cell`; returns the result object.  `prove_hook`, where
    given, wraps the program's prove in a cell on one card (the tests'
    faults); `options` makes the program prove at other options than the
    configuration's (the control), while the reference keeps the
    configuration's."""
    import torch

    cuda = torch.device(device).type == "cuda"
    if cell.chips > 1:
        if prove_hook is not None or options is not None:
            raise ValueError("faults and the control run on one card")
        w = _measure_ranks(cell, seconds, trace, device)
    else:
        w = _measure(cell, seconds, trace, device, prove_hook, options)
    rd = w.readings
    setup_s = w.start - t_start
    log(f"{cell.name}: set-up {setup_s:.3f} s")

    if cell.root not in sys.path:
        sys.path.insert(1, cell.root)
    air = load_air(cell.config, cell.root)
    t0 = time.perf_counter()
    ref_phases: dict = {}
    reference = air.reference(cell.config, cell.traffic, device,
                              phase_s=ref_phases)
    if cuda:
        torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    log(f"{cell.name}: reference phases (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in ref_phases.items()))
    counts = compare([w.distinct[d] for d in w.proofs], reference,
                     w.ext3)
    log(f"{cell.name}: reference {ref_s:.3f} s, {len(w.proofs)} proofs "
        f"compared, {len(w.distinct)} distinct")
    found = sorted(set(w.found) | set(forbidden_modules()))

    n = len(rd.latencies)
    metrics = {}
    if not trace:
        values = {
            "prove_s": mean_prove_s(rd.window_s, n) if n else None,
            "prove_p95_s": nearest_rank(rd.latencies, 0.95) if n else None,
            "peak_device_gib": w.peak / 2**30,
            "setup_s": setup_s,
        }
        # the part of an end-to-end metric's name before its first dot
        # says what it measures; the rest names a group of cells that
        # holds it to a bound of its own
        for m in cell.end_to_end:
            v = values.get(m["name"].split(".")[0])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = load_metric(m["name"], cell.root).read(rd)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    checks = {k: {"value": v, "limit": 0} for k, v in counts.items()}
    checks["failed"] = {"value": w.failed, "limit": 0}
    correct = (n > 0 and all(c["value"] <= c["limit"]
                             for c in checks.values()))
    devinfo = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
               "count": cell.chips, "memory_peak_bytes": w.peak}
    result = {"correct": correct, "attempted": w.attempted,
              "failed": w.failed, "metrics": metrics, "device": devinfo}
    if rd.profile is not None:
        p = rd.profile
        devinfo["busy_s"] = p["busy_s"]
        devinfo["window_s"] = p["wall_s"]
        result["breakdown"] = {
            "device_ops": [[k[:120], v] for k, v in sorted(
                p["ops"].items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [["idle in " + k, v] for k, v in sorted(
                p["idle_by_phase"].items(), key=lambda kv: -kv[1])[:10]]}
    result["checks"] = checks
    result["_forbidden"] = found
    device_ms = [sum(p["device_ms"] or 0.0 for p in log_)
                 for log_ in rd.phases]
    result["_window"] = {"proves": n, "window_s": rd.window_s,
                         "cold_prove_s": w.cold_s, "reference_s": ref_s,
                         "tenths_ms": [1e3 * t for t in
                                       _tenths(rd.latencies)],
                         "tenths_phase_device_ms": _tenths(device_ms)}
    return result


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs only on the card")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} present")
        return 2
    result = run_cell(cell, args.seconds, bool(args.trace), t_start)
    log(f"card: {_card()}; seed {args.seed}: {cell.config['seed']}")
    return emit(result)


def emit(result: dict) -> int:
    """Print the compared numbers and the result line; the exit code."""
    found = result.pop("_forbidden")
    window = result.pop("_window")
    log(f"window: {json.dumps(window)}")
    if found:
        log(f"forbidden modules loaded in this process: {found}")
        return 3
    for k, c in result["checks"].items():
        log(f"check {k}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0
