"""One run of one cell: set-up, the measured window, the check against the
reference, and the result line.

The driver of the cell's traffic (``drivers/<name>.py``) builds the program
under test through ``Run.estimator()``, warms it at the cell's own shapes,
calls ``Run.begin_window()`` when set-up is over, drives the window, drains
what was due in it, calls ``Run.end_window()`` and returns an ``Outcome``.
Then the peak of device memory is read, the program is freed, the
reference recomputes a sample of the served maps from the seed, and the
metrics' readers (``metrics/<name>.py``) read the outcome.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench import compare, spec as specs
from portbench.frames import Frames
from portbench.reference import frame as ref
from portbench.roofline import network_flops
from portbench.stats import latencies
from portbench.trace import DeviceTrace
from portbench.weights import make_weights

BANNED = ("jax", "jaxlib", "flax", "depth_estimation_tpu")
SAMPLE = 32  # served maps the reference recomputes in a run
DRAIN_S = 60.0  # how long past the window's close an answer is waited for


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is banned, compared whole (the
    program's package name begins with the JAX package's)."""
    return sorted(n for n in list(sys.modules) if n.split(".")[0] in BANNED)


@dataclasses.dataclass
class Outcome:
    """What a driver measured. Times are ``time.perf_counter()`` seconds."""
    attempted: int
    failed: int
    due: Optional[List[float]]  # when each request or frame was due; None in a closed loop
    done: List[Optional[float]]  # when each one's map was on the host; None if it never was
    outputs: Dict[int, np.ndarray]  # kept maps by request or frame index
    output: str  # "f32" or "u8"
    rows_per_program: int
    release: Callable[[], None]  # frees the program under test
    gen_lag: Optional[List[float]] = None  # seconds each arrival ran behind its due time
    server: Optional[Dict] = None  # batches and frames of the window's dispatches, max_batch
    stream_wall: Optional[List[float]] = None  # VidStream's dispatch-to-fetch spans
    spans: List[Tuple[float, float, str]] = dataclasses.field(default_factory=list)  # host spans
    idle_default: str = "host: program"


class Run:
    def __init__(self, spec: specs.Spec, workload: str, seed: int, seconds: float, trace: bool,
                 device="cuda", process_start: Optional[float] = None):
        self.spec = spec
        self.cell = spec.cell(workload)
        self.config = spec.config(self.cell["config"])
        self.traffic = specs.traffic(self.cell["traffic"])
        self.limits = specs.limits(workload)
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.device = torch.device(device)
        self.process_start = time.perf_counter() if process_start is None else process_start
        self.marks: List[Tuple[str, float]] = [("start", self.process_start), ("imports", time.perf_counter())]
        self.frames = Frames(self.seed, self.config["input_hw"], self.device)
        self.mark("device and frames")
        self.trace = DeviceTrace() if trace else None
        self.setup_s: Optional[float] = None
        self.t0 = self.t1 = None

    def mark(self, what: str) -> None:
        """The end of a step of set-up (printed on standard error)."""
        self.marks.append((what, time.perf_counter()))

    @property
    def tokens(self) -> int:
        return ref.net_tokens(self.config)

    @property
    def elem_bytes(self) -> int:
        return {"float32": 4, "bfloat16": 2}[self.config["dtype"]]

    # -- for drivers ----------------------------------------------------------

    def estimator(self):
        """The program under test on this seed's weights."""
        from depth_estimation_tpu_torch.estimator import DepthEstimator

        weights = make_weights(self.config, self.seed, self.device)
        self.mark("weights")
        est = DepthEstimator(self.config["model_type"], params=weights, dtype=self.config["dtype"],
                             device=self.device, verbose=False)
        del weights
        self.mark("estimator")
        return est

    def sample(self, n: int) -> set:
        """The indices, of ``n`` due, whose maps the reference recomputes:
        the first, the last and others drawn from the seed."""
        if n <= SAMPLE:
            return set(range(n))
        rng = np.random.default_rng([self.seed % (2 ** 63), 11])
        return {0, n - 1, *rng.choice(np.arange(1, n - 1), size=SAMPLE - 2, replace=False).tolist()}

    def begin_window(self, lead_s: float = 0.02) -> float:
        """Set-up ends: start the trace if asked, and return the window's start."""
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        if self.trace is not None:
            self.trace.start()
        self.mark("warm-up")
        self.t0 = time.perf_counter() + lead_s
        self.t1 = self.t0 + self.seconds
        self.setup_s = self.t0 - self.process_start
        return self.t0

    def end_window(self) -> None:
        if self.trace is not None:
            self.trace.stop()

    # -- after the window -----------------------------------------------------

    def check(self, out: Outcome) -> Tuple[bool, Dict[str, Dict[str, float]]]:
        """The served maps against the reference's, recomputed from the seed."""
        name = self.limits["compare"]
        if name != ("u8_gap" if out.output == "u8" else "max_scaled_err"):
            raise ValueError(f"{self.cell['name']}: a limit on {name} for {out.output} maps")
        kept = sorted(out.outputs)
        if len(kept) > SAMPLE:  # a closed loop keeps every map; draw the sample now
            kept = sorted(kept[i] for i in self.sample(len(kept)))
        weights = make_weights(self.config, self.seed, self.device)
        model = ref.build_model(self.config, weights, self.device)
        del weights
        worst = 0.0
        for i in range(0, len(kept), 8):
            idx = kept[i:i + 8]
            frames = torch.from_numpy(self.frames.stack(idx)).to(self.device)
            want = ref.depth_maps(model, frames, self.config)
            for j, k in enumerate(idx):
                got = torch.from_numpy(np.asarray(out.outputs[k])).to(self.device)
                gap = getattr(compare, name)(got, want[j])
                worst = max(worst, gap if math.isfinite(gap) else math.inf)
        del model
        limit = float(self.limits["limit"])
        checks = {"missing": {"value": out.failed + sum(d is None for d in out.done), "limit": 0},
                  "compared": {"value": len(kept), "limit": min(SAMPLE, len(out.done))},
                  name: {"value": worst, "limit": limit}}
        ok = (checks["missing"]["value"] == 0 and len(kept) >= checks["compared"]["limit"] and worst <= limit)
        return ok, checks


@dataclasses.dataclass
class Record:
    """What the metrics' readers read."""
    run: Run
    out: Outcome
    peak_mem_bytes: int
    device_name: str

    @property
    def window(self) -> Tuple[float, float]:
        return self.run.t0, self.run.t1

    def completed_in_window(self) -> int:
        t0, t1 = self.window
        return sum(1 for d in self.out.done if d is not None and t0 <= d <= t1)

    def latencies(self) -> List[float]:
        return latencies(self.out.due, self.out.done)

    def flops_per_frame(self) -> float:
        return network_flops(self.run.config)

    def events(self):
        return self.run.trace.events if self.run.trace is not None else None


def read_metrics(rec: Record, metrics: Sequence[Dict], required: bool) -> Dict[str, Dict]:
    values = {}
    for m in metrics:
        v = specs.reader(m["name"]).read(rec, m)
        if v is None:
            if required:
                raise RuntimeError(f"end-to-end metric {m['name']} has no reading")
            continue
        values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return values


def run_cell(spec: specs.Spec, workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             process_start: Optional[float] = None) -> Dict:
    """One run; returns the result line's object (``checks`` last when printed)."""
    run = Run(spec, workload, seed, seconds, trace, device, process_start)
    out = specs.driver(run.traffic["driver"]).run(run)
    cuda = run.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    device_name = torch.cuda.get_device_name(run.device) if cuda else "cpu"
    out.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rec = Record(run, out, peak, device_name)
    metrics = spec.metrics(workload)
    values = (read_metrics(rec, metrics["per_layer"], required=False) if trace
              else read_metrics(rec, metrics["end_to_end"], required=True))
    correct, checks = run.check(out)
    result = {"correct": bool(correct), "attempted": out.attempted, "failed": out.failed, "metrics": values,
              "device": {"platform": "gpu" if cuda else "cpu", "kind": device_name,
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if trace and run.trace is not None and run.trace.events is not None:
        from portbench import trace as tr

        busy = tr.busy_intervals(run.trace.events, run.t0, run.t1)
        result["device"]["busy_s"] = sum(e - s for s, e in busy)
        result["device"]["window_s"] = run.t1 - run.t0
        result["breakdown"] = tr.breakdown(run.trace.events, out.spans, run.t0, run.t1, out.idle_default)
    result["checks"] = checks
    steps = run.marks
    result["setup_steps"] = {b[0]: b[1] - a[1] for a, b in zip(steps, steps[1:])}
    banned = banned_modules()  # last: after the readers, the trace's breakdown and the reference
    if banned:
        raise RuntimeError(f"modules of JAX or of the JAX package are loaded: {banned}")
    return result
