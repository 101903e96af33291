"""The harness: one run of one cell of ``BENCHMARK.json``.

A cell names a configuration and a traffic mix; everything that belongs to
one of them, or to one metric, sits in a file of its own that the harness
finds by name, so a later cell, mix or metric is new files plus new entries:

* ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives): sizes and
  the name of the input generator;
* ``inputs/<generator>.py``: ``operands(cfg, seed, structure, device)``
  (CSR arrays on the device by operand name) and ``value_sets(cfg, name, base, count, gen)``
  (new values of an operand, made on the device);
* ``traffic/<traffic>.json``: the loop and, product by product, the
  operation, the program's entry and its options (see ``Traffic``);
* ``reference/<op>.py``: the plain reference of an operation,
  ``compute(a, b, dtype, with_scale)`` and ``work(a, b, c, batch)``;
* ``metrics/<metric>.py``: ``read(run)``, a metric from the window's record
  and, in a traced run, its ``TraceData``; None where there is nothing to read;
* ``limits/<workload>.json``: the limit of each number the check compares.

A run makes the inputs from the seed, pins or warms up what the loop uses,
measures a closed loop of one client for ``seconds`` seconds (under
``torch.profiler`` when traced), reads the device's peak memory, frees the
program's state and then holds a sample of the window's answers, drawn from
the seed, against the float64 reference in ``reference/``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import random
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import pb_yardstick
from pb_trace import TraceData

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_module(path: Path, name: str):
    """Import the file ``path`` as module ``name`` (metric files have dots in
    their names, so they are loaded by path, not by import)."""
    if name in sys.modules:
        return sys.modules[name]
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Csr:
    """A CSR matrix: ``indptr`` (m+1,), ``indices`` (nnz,), ``values`` (nnz,);
    ``scale`` (nnz,) float64, the sum of |products| behind each value of a
    reference's answer, or None for an input (whose scale is |values|)."""

    indptr: torch.Tensor
    indices: torch.Tensor
    values: torch.Tensor
    shape: tuple
    scale: torch.Tensor | None = None

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])


def reference(op: str):
    """The plain reference of operation ``op``: ``reference/<op>.py``."""
    return load_module(HERE / "reference" / f"{op}.py", f"pb_reference_{op}")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def derive(seed: int, *tags: int) -> int:
    """A 63-bit seed for one use (``tags``) of the run's ``--seed``."""
    state = np.random.SeedSequence([seed % (1 << 64), *tags]).generate_state(2, np.uint64)
    return int(state[0]) >> 1


VALUES, ORDER, SAMPLES = 1, 2, 3  # the uses of the seed
CHECK_SAMPLES = 3  # answers of a window held against the reference


@dataclasses.dataclass
class Product:
    """One product of a mix's chain: ``name`` = ``a`` · ``b`` by operation
    ``op`` (its reference is ``reference/<op>.py``). A replay loop pins it
    with ``options`` (``ReuseExecutor.from_matrices``'s keywords); a fresh
    loop calls the port's function ``call`` ("module:name") with them."""

    name: str
    a: str
    b: str
    op: str = "spgemm"
    call: str | None = None
    options: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Traffic:
    """A closed loop of one client, from ``traffic/<name>.json``.

    ``entry``: "replay" (pin each product once in set-up, then each step
    replays the chain on the step's values) or "fresh" (each step multiplies
    the chain anew). ``products``: the chain, each ``{"name", "a", "b"}``,
    whose operands are inputs or earlier products (see ``Product``).
    ``structures``: how many input structures the generator makes (a fresh
    loop cycles over them in an order drawn from the seed). ``vary`` and
    ``value_sets``: the operands whose values change, and how many value
    sets a replay loop cycles over. ``batch``: value sets a replay call
    takes, stacked (``apply_batched`` where above 1; ``value_sets`` is a
    multiple of it). ``sync``: "each" (the client waits for every step) or
    "end" (steps are issued back to back, one synchronisation closes the
    window)."""

    entry: str
    products: list
    structures: int = 1
    vary: tuple = ()
    value_sets: int = 1
    batch: int = 1
    sync: str = "end"

    @classmethod
    def load(cls, path: Path) -> "Traffic":
        raw = json.loads(path.read_text())
        raw["products"] = [Product(**p) for p in raw["products"]]
        raw["vary"] = tuple(raw.get("vary", ()))
        t = cls(**raw)
        if t.entry not in ("replay", "fresh") or t.sync not in ("each", "end"):
            raise ValueError(f"{path}: entry {t.entry!r} / sync {t.sync!r}")
        if t.batch < 1 or t.value_sets % t.batch:
            raise ValueError(f"{path}: {t.value_sets} value sets in batches of {t.batch}")
        if t.entry == "fresh" and any(p.call is None for p in t.products):
            raise ValueError(f"{path}: a fresh loop names the port's function of each product")
        return t


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with the files it names."""

    name: str
    chips: int
    config: dict
    traffic: Traffic
    generator: object
    limits: dict
    end_to_end: list
    per_layer: list

    @classmethod
    def load(cls, root: Path, workload: str) -> "Cell":
        """The cell ``workload`` of ``root/BENCHMARK.json``, its files taken
        from ``root``'s copy of this directory."""
        base = root / HERE.name
        bench = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        w = cells[workload]
        configs = {c["name"]: c for c in bench["configs"]}
        config = json.loads((root / configs[w["config"]]["file"]).read_text())
        gen = load_module(base / "inputs" / f"{config['generator']}.py",
                          f"pb_inputs_{config['generator']}")

        def mine(metrics):
            return [m for m in metrics if workload in m.get("workloads", [workload])]

        return cls(name=workload, chips=w["chips"], config=config,
                   traffic=Traffic.load(base / "traffic" / f"{w['traffic']}.json"),
                   generator=gen,
                   limits=json.loads((base / "limits" / f"{workload}.json").read_text()),
                   end_to_end=mine(bench["end_to_end"]), per_layer=mine(bench["per_layer"]))


@dataclasses.dataclass
class Run:
    """What the metric readers see of one run."""

    entry: str
    steps: int = 0
    calls: int = 0  # replay calls (steps times the chain's products)
    call_host_s: float = 0.0  # host seconds inside the replay calls (traced runs)
    window_s: float = 0.0
    latencies_s: list = dataclasses.field(default_factory=list)
    setup_s: float = 0.0
    peak_bytes: int = 0  # the window's peak, less the answers held for the check
    trace: object = None  # pb_trace.TraceData in a traced run
    work: dict = dataclasses.field(default_factory=dict)  # product -> (count, bytes, flops)


def held_bytes(items) -> int:
    """Device bytes of the tensors in ``items`` (dicts, lists, tuples and
    records of them), each storage once, in the allocator's 512-byte
    blocks."""
    storages: dict = {}

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                st = x.untyped_storage()
                storages[st.data_ptr()] = st.nbytes()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))

    walk(items)
    return sum(-(-n // 512) * 512 for n in storages.values())


class Reservoir:
    """A uniform sample of ``k`` of the window's answers, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items, self.seen = k, random.Random(seed), [], 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _smi(device, fields: str) -> str | None:
    """One line of ``nvidia-smi --query-gpu=<fields>`` for ``device``."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    lines = out.stdout.strip().splitlines() if out.returncode == 0 else []
    index = torch.device(device).index or 0
    return lines[index].strip() if len(lines) > index else None


def card_info(device) -> dict:
    """The card's name and power limit, or the CPU's name."""
    if torch.device(device).type != "cuda":
        return {"kind": "cpu", "power_limit": None}
    limit = _smi(device, "power.limit")
    return {"kind": torch.cuda.get_device_name(device), "power_limit": limit}


def card_state(device) -> str:
    """The card's clocks, power draw, temperature and active throttle
    reasons, logged beside each window: a slow run can then be told apart
    from a slow card."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return _smi(device, "clocks.sm,clocks.mem,power.draw,temperature.gpu,"
                        "clocks_throttle_reasons.active") or "nvidia-smi gave nothing"


def compare(indptr, indices, values, want: Csr) -> tuple[int, float]:
    """(structure mismatches, worst |value - reference| / scale) of one
    answer. Mismatches count the row pointers that differ, else the column
    indices that differ; the values are compared only on equal structures."""
    ip = indptr.long()
    if ip.shape != want.indptr.shape:
        return abs(ip.shape[0] - want.indptr.shape[0]) or 1, math.inf
    bad = int((ip != want.indptr).sum())
    nnz = int(ip[-1])
    if bad == 0:
        bad = int((indices[:nnz].long() != want.indices).sum())
    if bad:
        return bad, math.inf
    if nnz == 0:
        return 0, 0.0
    gap = (values[:nnz].double() - want.values).abs()
    err = float((gap / want.scale.clamp_min(1e-300)).max())
    return 0, err if math.isfinite(err) else math.inf  # NaN fails as inf


class Harness:
    """One run of ``cell``: ``run(seed, seconds, trace)``."""

    def __init__(self, cell: Cell, system, device="cuda", t_start: float | None = None):
        self.cell, self.system, self.device = cell, system, torch.device(device)
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.host_spans = False  # host operations and spans are being recorded
        self.timed_calls = None  # [seconds] inside replay calls, in a traced run

    def annotate(self, name: str):
        if not self.host_spans:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    # ----- set-up ---------------------------------------------------------

    def inputs(self, seed: int) -> list:
        t = self.cell.traffic
        out = []
        for s in range(t.structures):
            arrays = self.cell.generator.operands(self.cell.config, seed, s, self.device)
            out.append({k: Csr(indptr=ip, indices=ix, values=v, shape=tuple(shape))
                        for k, (ip, ix, v, shape) in arrays.items()})
        return out

    def value_sets(self, ops: dict, seed: int) -> dict:
        """Each varying operand's value sets: a list of 1-D arrays, or, where
        a replay call takes a batch, of the batches stacked."""
        t = self.cell.traffic
        gen = torch.Generator(device=self.device)
        gen.manual_seed(derive(seed, VALUES))
        out = {}
        for name in t.vary:
            sets = self.cell.generator.value_sets(self.cell.config, name, ops[name],
                                                  t.value_sets, gen)
            if t.batch > 1:
                sets = [torch.stack(sets[g:g + t.batch]) for g in range(0, len(sets), t.batch)]
            out[name] = sets
        return out

    # ----- the loops --------------------------------------------------------

    def _replay(self, handle, a_values, b_values):
        if self.timed_calls is None:
            return self.system.replay(handle, a_values, b_values)
        c0 = time.perf_counter()
        out = self.system.replay(handle, a_values, b_values)
        self.timed_calls.append(time.perf_counter() - c0)
        return out

    def _replay_step(self, handles, ops, vsets, v):
        cur = {name: (vsets[name][v] if name in vsets else x.values) for name, x in ops.items()}
        for p in self.cell.traffic.products:
            cur[p.name] = self._replay(handles[p.name], cur[p.a], cur[p.b])
        return {p.name: cur[p.name] for p in self.cell.traffic.products}

    def _fresh_step(self, ops):
        cur = dict(ops)
        for p in self.cell.traffic.products:
            cur[p.name] = self.system.fresh(cur[p.a], cur[p.b], p.call, p.options)
            if p is not self.cell.traffic.products[-1]:  # a later product's operand
                indptr, indices, values = self.system.csr(cur[p.name])
                cur[p.name] = Csr(indptr=indptr, indices=indices, values=values,
                                  shape=(cur[p.a].shape[0], cur[p.b].shape[1]))
        return {p.name: cur[p.name] for p in self.cell.traffic.products}

    def run(self, seed: int, seconds: float, trace: bool) -> dict:
        t = self.cell.traffic
        info = card_info(self.device)
        log(f"{self.cell.name}: seed {seed}, {seconds} s, trace {int(trace)}; "
            f"{info['kind']}, power limit {info['power_limit']}")
        self.system.set_trace_mode("off")
        structures = self.inputs(seed)
        log(f"   inputs made at {time.perf_counter() - self.t_start:.2f} s")
        for s, ops in enumerate(structures):
            log("   structure %d: %s" % (s, ", ".join(
                f"{k} {tuple(v.shape)} nnz {v.nnz}" for k, v in ops.items())))
        if t.entry == "replay":
            ops = structures[0]
            vsets = self.value_sets(ops, seed)
            groups = t.value_sets // t.batch
            handles, chain = {}, dict(ops)
            for p in t.products:  # pin the chain; a later product pins on an earlier one
                handles[p.name] = self.system.pin(chain[p.a], chain[p.b], p.options)
                indptr, indices = self.system.structure(handles[p.name])
                chain[p.name] = Csr(indptr=indptr, indices=indices,
                                    values=self.system.replay(handles[p.name], chain[p.a].values,
                                                              chain[p.b].values),
                                    shape=(chain[p.a].shape[0], chain[p.b].shape[1]))
            del chain
            self._replay_step(handles, ops, vsets, 0)

            def step(i):
                v = i % groups
                return v, self._replay_step(handles, ops, vsets, v)
        else:
            vsets, handles = {}, {}
            order = np.random.default_rng(derive(seed, ORDER)).permutation(t.structures)
            for s in range(t.structures):
                self._fresh_step(structures[s])

            def step(i):
                s = int(order[i % t.structures])
                with self.annotate("bench.multiply"):
                    return s, self._fresh_step(structures[s])
        sync(self.device)
        log(f"   pinned and warmed up at {time.perf_counter() - self.t_start:.2f} s")
        cuda = self.device.type == "cuda"
        setup_peak = torch.cuda.max_memory_allocated(self.device) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        run = Run(entry=t.entry)
        sample = Reservoir(CHECK_SAMPLES, derive(seed, SAMPLES))
        log(f"   card before the window: {card_state(self.device)}")
        prof = None
        if trace:
            # host operations and spans are recorded only where a metric of
            # the cell reads the program's spans: recording every host
            # operation slows a loop of short replays until the host, not
            # the device, sets its pace
            self.host_spans = not cuda or any(getattr(m, "PROGRAM_SPANS", False)
                                              for m in self._readers(self.cell.per_layer))
            if self.host_spans:
                self.system.set_trace_mode("xprof")
            self.timed_calls = []
            acts = [torch.profiler.ProfilerActivity.CUDA] if cuda else []
            if self.host_spans:
                acts.append(torch.profiler.ProfilerActivity.CPU)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        # ----- the measured window -----
        t0 = time.perf_counter()
        run.setup_s = t0 - self.t_start
        deadline = t0 + seconds
        i = 0
        with self.annotate("bench.window"):
            while time.perf_counter() < deadline:
                c0 = time.perf_counter()
                item = step(i)
                if t.sync == "each":
                    sync(self.device)
                    run.latencies_s.append(time.perf_counter() - c0)
                sample.offer(item)
                del item  # a step's answer lives on only where the sample keeps it
                i += 1
            sync(self.device)
        run.window_s = time.perf_counter() - t0
        # ----- the window has closed -----
        run.steps = i
        run.calls = i * len(t.products) if t.entry == "replay" else 0
        if prof is not None:
            prof.__exit__(None, None, None)
            self.system.set_trace_mode("off")
            self.host_spans = False
            run.call_host_s = sum(self.timed_calls)
            self.timed_calls = None
            t_read = time.perf_counter()
            run.trace = TraceData.from_profiler(prof)
            del prof
            log(f"   trace: {run.trace.device_events} device operations read in "
                f"{time.perf_counter() - t_read:.1f} s")
        log(f"   card after the window: {card_state(self.device)}")
        held = held_bytes(sample.items)
        window_peak = torch.cuda.max_memory_allocated(self.device) if cuda else 0
        run.peak_bytes = max(window_peak - held, 0)
        log(f"   device memory: set-up peak {setup_peak} B, window peak {window_peak} B, "
            f"of which {held} B the {len(sample.items)} answers held for the check")
        structure_of = {p: self.system.structure(h) for p, h in handles.items()}
        del handles, step
        self.system.release()
        if cuda:
            torch.cuda.empty_cache()
        checks, failed, sizes = self.check(structures, vsets, structure_of, sample.items)
        for p in t.products:
            b, f = sizes[p.name]
            run.work[p.name] = (run.steps, b, f)
        return self.result(run, checks, failed, info, setup_peak)

    # ----- correctness ------------------------------------------------------

    def check(self, structures, vsets, structure_of, items):
        """Hold each sampled answer against the reference; returns the
        numbers compared, the answers that failed, and each product's
        (bytes, flops) of a numeric phase a step, from the reference's sizes."""
        t = self.cell.traffic
        worst: dict = {}
        failed, sizes = 0, {}
        t_ref = time.perf_counter()
        for key, answer in items:
            # a replay answer holds a batch of value sets (one where batch is 1)
            for j in range(t.batch if t.entry == "replay" else 1):
                if t.entry == "replay":
                    cur = {n: dataclasses.replace(x, values=vsets[n][key][j] if t.batch > 1
                                                  else vsets[n][key]) if n in vsets else x
                           for n, x in structures[0].items()}
                else:
                    cur = dict(structures[key])
                bad_answer = False
                for p in t.products:
                    op = reference(p.op)
                    want = op.compute(cur[p.a], cur[p.b])
                    if t.entry == "replay":
                        indptr, indices = structure_of[p.name]
                        got = answer[p.name][j] if t.batch > 1 else answer[p.name]
                    else:
                        indptr, indices, got = self.system.csr(answer[p.name])
                    mismatch, err = compare(indptr, indices, got, want)
                    for name, value in ((f"{p.name}.structure", mismatch),
                                        (f"{p.name}.value_err", err)):
                        worst[name] = max(worst.get(name, 0), value)
                        bad_answer |= not value <= self.limit(name)
                    sizes[p.name] = op.work(cur[p.a], cur[p.b], want, t.batch)
                    cur[p.name] = want
                failed += bad_answer
        if not items:
            log("   no answer to check: the window completed no step")
        log(f"   reference: {len(items)} answers in {time.perf_counter() - t_ref:.1f} s")
        return worst, failed, sizes

    def limit(self, name: str) -> float:
        if name not in self.cell.limits:
            raise KeyError(f"limits/{self.cell.name}.json has no limit for {name}")
        return self.cell.limits[name]["limit"]

    # ----- the result -------------------------------------------------------

    def _readers(self, metrics):
        return [load_module(HERE / "metrics" / f"{m['name']}.py", f"pb_metric_{m['name']}")
                for m in metrics]

    def result(self, run: Run, checks: dict, failed: int, info: dict, setup_peak: int) -> dict:
        metrics = {}
        wanted = self.cell.per_layer if run.trace is not None else self.cell.end_to_end
        for m, reader in zip(wanted, self._readers(wanted)):
            value = reader.read(run)
            if value is None:
                if run.trace is None and self.device.type == "cuda":
                    raise RuntimeError(f"end-to-end metric {m['name']} has no reading")
                log(f"   {m['name']}: nothing to read in this run")
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if run.latencies_s:
            log(f"   {len(run.latencies_s)} timed calls in the window")
        log(f"   {run.steps} steps in {run.window_s:.3f} s; set-up {run.setup_s:.3f} s")
        device = {"platform": "gpu" if self.device.type == "cuda" else "cpu",
                  "kind": info["kind"], "count": self.cell.chips,
                  "memory_peak_bytes": run.peak_bytes, "setup_peak_bytes": setup_peak,
                  "power_limit": info["power_limit"]}
        out = {"correct": False, "attempted": run.steps, "failed": failed,
               "metrics": metrics, "device": device}
        if run.trace is not None:
            device["busy_s"] = run.trace.busy_s
            device["window_s"] = run.window_s
            out["breakdown"] = run.trace.breakdown()
        compared = {}
        ok = bool(checks) and run.steps > 0
        for name, value in sorted(checks.items()):
            limit = self.limit(name)
            ok &= value <= limit
            compared[name] = {"value": value if math.isfinite(value) else None, "limit": limit}
        out["correct"] = bool(ok)
        out["checks"] = compared  # last: each number compared beside its limit
        for name, c in compared.items():
            log(f"check {name}: {c['value']} (limit {c['limit']})")
        return out
