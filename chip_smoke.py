#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. environment: card name and power limit, torch and CUDA versions; TF32
   off for matmuls and convolutions;
2. build: compile the fused-MLP kernel library with nvcc (sm_90a);
3. kernel parity: the kernel against its plain PyTorch version at every
   DFP layer shape, M in {1, 2, 4, 8, 16, 37}, all four activations,
   float32 (rtol = atol = 2e-4) and bfloat16 (2e-2);
4. timing: kernel, plain version and ``torch.addmm`` + activation (the
   library yardstick, which the port never calls) at the main-path
   shapes, each beside its bound; the whole 13-layer DFP forward;
5. main path: a paper-width MRSch agent (state_dim 11410, random weights
   from a seed) behind a ``DecisionService(max_batch=16)`` replays
   full-scale Theta S1 traces, one alone and eight from concurrent client
   threads; the kernel's launch count must be 13 per forward, and sampled
   served rows must score the same on the kernel and the plain backend.

The line before the last is a JSON summary of the kernels; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero before printing either.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import threading
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and float32 rate outside the
# tensor cores (the kernel runs float32 FMAs on the CUDA cores).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAKS = "H100 SXM data sheet: 3.35 TB/s HBM3, 67 TFLOP/s float32 (700 W)"

DFP_SHAPES = [(11410, 4000), (4000, 1000), (1000, 512), (2, 128), (128, 128),
              (768, 512), (512, 12), (512, 120)]
PARITY_M = (1, 2, 4, 8, 16, 37)
TIMING_M = (1, 8, 16)
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}

KERNEL_SOURCE = "src/repro_torch/kernels/fused_mlp/csrc/fused_mlp.cu"
KERNEL_REPLACES = "src/repro/kernels/fused_mlp/kernel.py:85"


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phases
def phase_env() -> str:
    card = gpu_name_and_power_limit()
    log(card)
    log(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"python {sys.version.split()[0]}  device "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build() -> float:
    from repro_torch.kernels.fused_mlp import kernel
    info = kernel.build()
    kernel._library()
    log(f"[build] {info.library.name}: {info.seconds:.3f} s of nvcc")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    return info.seconds


def phase_parity() -> float:
    """Kernel vs plain version on the card; returns the worst float32
    absolute error."""
    from repro_torch.kernels.fused_mlp import (ACTIVATIONS, fused_mlp,
                                               fused_mlp_layer_ref)
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n = 0
    for k, n_out in DFP_SHAPES:
        w32 = torch.randn(k, n_out, generator=gen, device="cuda") / math.sqrt(k)
        b32 = 0.1 * torch.randn(n_out, generator=gen, device="cuda")
        for dtype, tol in TOL.items():
            w, b = w32.to(dtype), b32.to(dtype)
            for m in PARITY_M:
                x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
                for act in ACTIVATIONS:
                    with torch.no_grad():
                        y = fused_mlp(x, w, b, activation=act).float()
                        r = fused_mlp_layer_ref(x, w, b, act).float()
                    torch.cuda.synchronize()
                    err = (y - r).abs()
                    bad = err > tol + tol * r.abs()
                    if bad.any():
                        raise AssertionError(
                            f"[parity] K={k} N={n_out} M={m} {dtype} {act}: "
                            f"{int(bad.sum())} elements off, max abs err "
                            f"{float(err.max())}")
                    worst[dtype] = max(worst[dtype], float(err.max()))
                    n += 1
    log(f"[parity] {n} cases pass; worst abs err float32 "
        f"{worst[torch.float32]!r} (tol 2e-4), bfloat16 "
        f"{worst[torch.bfloat16]!r} (tol 2e-2)")
    return worst[torch.float32]


def forward_layers(net) -> list:
    """(K, N, activation) of the 13 dense layers of one DFP forward."""
    out = []
    for name, final in (("state", "leaky_relu"), ("measurement", "leaky_relu"),
                        ("goal", "leaky_relu"), ("expectation", "linear"),
                        ("action", "linear")):
        layers = getattr(net, name).layers
        for i, layer in enumerate(layers):
            k, n = layer.w.shape
            out.append((k, n, "leaky_relu" if i < len(layers) - 1 else final))
    return out


def bound_ms(m: int, k: int, n: int) -> tuple:
    """(bytes, operations) times of one float32 layer, in ms: x, W, b read
    once and y written once over the HBM rate; 2MKN flops over the
    float32 rate.  The bound is the larger of the two."""
    byte_s = 4.0 * (m * k + k * n + n + m * n) / PEAK_BYTES_PER_S
    flop_s = 2.0 * m * k * n / PEAK_F32_FLOP_PER_S
    return byte_s * 1e3, flop_s * 1e3


def device_ms(fn, flush: torch.Tensor, reps: int = 15,
              sleep_cycles: int = 2_000_000) -> float:
    """Median device time of one call of ``fn``, timed with CUDA events,
    with L2 flushed before each call (a forward finds each layer's W cold:
    the 182.6 MB first layer evicts the rest).  A device-side sleep after
    the flush keeps the card busy while the host enqueues ``fn``, so the
    host's time to prepare the launches is not counted."""
    pairs = []
    for _ in range(reps + 2):
        flush.zero_()
        torch.cuda._sleep(sleep_cycles)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs[2:])


def phase_timing(agent) -> dict:
    from repro_torch.core.dfp import action_values
    from repro_torch.kernels.fused_mlp import fused_mlp, fused_mlp_layer_ref
    log(f"[timing] bounds from {PEAKS}; card: {gpu_name_and_power_limit()}")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    layers = forward_layers(agent.net)
    per_shape = {}
    for k, n in DFP_SHAPES:
        w = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
        b = 0.1 * torch.randn(n, generator=gen, device="cuda")
        for act in sorted({a for kk, nn_, a in layers if (kk, nn_) == (k, n)}):
            for m in TIMING_M:
                x = torch.randn(m, k, generator=gen, device="cuda")
                lib_act = ((lambda y: F.leaky_relu(y, 0.2))
                           if act == "leaky_relu" else (lambda y: y))
                with torch.no_grad():
                    t_k = device_ms(lambda: fused_mlp(x, w, b, activation=act),
                                    flush)
                    t_p = device_ms(lambda: fused_mlp_layer_ref(x, w, b, act),
                                    flush)
                    t_l = device_ms(lambda: lib_act(torch.addmm(b, x, w)),
                                    flush)
                b_ms, o_ms = bound_ms(m, k, n)
                per_shape[(k, n, act, m)] = (t_k, t_p, t_l, b_ms, o_ms)
                log(f"[timing] layer K={k:5d} N={n:4d} {act:10s} M={m:2d}: "
                    f"kernel {t_k:.4f} ms  plain {t_p:.4f} ms  "
                    f"addmm+act {t_l:.4f} ms  bound {max(b_ms, o_ms):.4f} ms "
                    f"({'bytes' if b_ms >= o_ms else 'operations'})")
    sums = {}
    for m in TIMING_M:
        rows = [per_shape[(k, n, a, m)] for k, n, a in layers]
        t_k, t_p, t_l, b_ms, o_ms = (sum(r[i] for r in rows)
                                     for i in range(5))
        by = "bytes" if b_ms >= o_ms else "operations"
        sums[m] = (t_k, t_p, t_l, max(b_ms, o_ms), by)
        log(f"[timing] 13 layers at M={m:2d}, summed: kernel {t_k:.4f} ms  "
            f"plain {t_p:.4f} ms  addmm+act {t_l:.4f} ms  bound "
            f"{max(b_ms, o_ms):.4f} ms ({by})")
    # The whole forward (``action_values``, 13 dense layers plus the dueling
    # and goal arithmetic), W streaming from HBM: its device time, then
    # back to back as a loop of calls (what the host sustains), then one
    # call waited for (what a request sees).  Runs in the order kernel,
    # torch, torch, kernel.
    dfp_torch = replace(agent.dfp, backend="torch")
    sd, nm = agent.dfp.state_dim, agent.dfp.n_measurements
    forward = {}
    for m in TIMING_M:
        state = torch.rand(m, sd, generator=gen, device="cuda")
        meas = torch.rand(m, nm, generator=gen, device="cuda")
        goal = torch.softmax(torch.rand(m, nm, generator=gen, device="cuda"),
                             -1)
        runs = {"kernel": [], "torch": []}
        for dfp in (agent.dfp, dfp_torch, dfp_torch, agent.dfp):
            fwd = lambda: action_values(agent.net, dfp, state, meas, goal)
            dev = device_ms(fwd, flush, reps=10, sleep_cycles=20_000_000)
            reps = 30
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(reps):
                fwd()
            e1.record()
            torch.cuda.synchronize()
            loop = e0.elapsed_time(e1) / reps
            lat = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fwd()
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
            runs[dfp.backend].append((dev, loop, statistics.median(lat)))
        forward[m] = runs
        for be, r in runs.items():
            log(f"[timing] whole forward M={m:2d} {be:6s}: device "
                f"{r[0][0]:.4f}/{r[1][0]:.4f} ms  back-to-back "
                f"{r[0][1]:.4f}/{r[1][1]:.4f} ms  waited-for call "
                f"{r[0][2]:.4f}/{r[1][2]:.4f} ms  (bound {sums[m][3]:.4f} ms)")
    return {"sums": sums, "forward": forward}


class SampledPolicy:
    """ServicePolicy that also keeps every ``every``-th served row and the
    action the service gave it."""

    def __init__(self, service, sink: list, every: int):
        from repro_torch.serve import ServicePolicy
        self._inner = ServicePolicy(service, track_latency=True)
        self.latencies_s = self._inner.latencies_s
        self.service, self.sink, self.every, self.n = service, sink, every, 0

    def select(self, ctx) -> int:
        action = self._inner.select(ctx)
        if self.n % self.every == 0:
            self.sink.append((self.service._encode(ctx), action))
        self.n += 1
        return action


def phase_main_path(agent) -> dict:
    from repro_torch.core.dfp import action_values
    from repro_torch.kernels.fused_mlp import fused_mlp
    from repro_torch.serve import DecisionService, ServeConfig, ServiceSim
    from repro_torch.workloads import ThetaConfig, build_scenarios

    def s1(seed: int):
        cfg = ThetaConfig(duration_days=2.0, jobs_per_day=160.0, seed=seed)
        return cfg.resources(), build_scenarios(cfg, ("S1",))["S1"]

    res, jobs_a = s1(0)
    traces_b = [s1(seed)[1] for seed in range(1, 9)]
    assert agent.enc.state_dim == 11410, agent.enc.state_dim
    sampled: list = []

    svc = DecisionService(agent, ServeConfig(max_batch=16))
    fused_mlp.launches = 0
    t0 = time.perf_counter()
    svc.start()                                      # warm-up forwards
    warm_s = time.perf_counter() - t0

    # (a) one trace, one client
    ssim = ServiceSim(svc, res)
    ssim.policy = SampledPolicy(svc, sampled, every=25)
    t0 = time.perf_counter()
    res_a = ssim.run_trace(jobs_a)
    wall_a = time.perf_counter() - t0
    lat_a = list(ssim.policy.latencies_s)
    hist_a = svc.stats()["batch_hist"]

    # (b) eight clients, one trace each, concurrently
    results_b, lat_b, errors = [None] * 8, [], []

    def client(i: int) -> None:
        try:
            sim = ServiceSim(svc, res)
            sim.policy = SampledPolicy(svc, sampled, every=50)
            results_b[i] = sim.run_trace(traces_b[i])
            lat_b.extend(sim.policy.latencies_s)
        except BaseException as e:                   # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall_b = time.perf_counter() - t0
    if errors:
        raise errors[0]
    assert all(not t.is_alive() for t in threads), "client threads hung"
    svc.stop()
    torch.cuda.synchronize()
    launches = fused_mlp.launches
    stats = svc.stats()

    # Launches: 13 dense layers per forward, one forward per dispatch
    # (warm-up widths + served batches).
    forwards = stats["buckets"]["dispatches"]
    assert forwards == len(svc._buckets.widths) + stats["batches"], stats
    assert launches > 0 and launches == 13 * forwards, (launches, forwards)

    dec_a = res_a.decisions
    dec_b = sum(r.decisions for r in results_b)
    assert dec_a == len(lat_a) and dec_b == len(lat_b)
    assert stats["requests"] == dec_a + dec_b
    for r in [res_a, *results_b]:
        row = r.metrics.as_row()
        assert r.decisions > 0 and r.n_unstarted == 0, (r.decisions,
                                                        r.n_unstarted)
        assert all(math.isfinite(v) for v in row.values()), row
    hist_b = {w: c - hist_a.get(w, 0) for w, c in stats["batch_hist"].items()
              if c - hist_a.get(w, 0)}

    # Sampled served rows: kernel backend vs plain backend on the card.
    sd, m = agent.enc.state_dim, agent.enc.n_resources
    dfp_torch = replace(agent.dfp, backend="torch")
    rows = torch.from_numpy(np.stack([r for r, _ in sampled])).to(agent.device)
    served = np.asarray([a for _, a in sampled])
    u_k, u_t = [], []
    for i in range(0, rows.shape[0], 16):            # service-sized batches
        chunk = rows[i:i + 16]
        args = (chunk[:, :sd].contiguous(), chunk[:, sd:sd + m].contiguous(),
                chunk[:, sd + m:sd + 2 * m].contiguous())
        u_k.append(action_values(agent.net, agent.dfp, *args))
        u_t.append(action_values(agent.net, dfp_torch, *args))
    valid = rows[:, sd + 2 * m:] > 0.5
    u_k = torch.where(valid, torch.cat(u_k), -torch.inf).cpu().numpy()
    u_t = torch.where(valid, torch.cat(u_t), -torch.inf).cpu().numpy()
    fin = np.isfinite(u_t)
    assert (np.isfinite(u_k) == fin).all()
    scale = max(1.0, float(np.abs(u_t[fin]).max()))
    tol = 2e-4 * scale
    err = float(np.abs(u_k[fin] - u_t[fin]).max())
    assert err <= tol, f"kernel vs torch action values: {err} > {tol}"
    top2 = np.sort(np.where(fin, u_t, -np.inf), axis=1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]                 # inf with one valid slot
    decisive = margin > tol
    assert (u_k.argmax(1)[decisive] == u_t.argmax(1)[decisive]).all()
    assert (served[decisive] == u_t.argmax(1)[decisive]).all()

    lat = np.asarray(lat_a + lat_b) * 1e3
    out = {
        "launches": launches, "forwards": forwards,
        "batches": stats["batches"], "warmup_s": warm_s,
        "decisions_a": dec_a, "wall_a_s": wall_a,
        "decisions_b": dec_b, "wall_b_s": wall_b,
        "dps_a": dec_a / wall_a, "dps_b": dec_b / wall_b,
        "p50_a_ms": float(np.percentile(np.asarray(lat_a) * 1e3, 50)),
        "p99_a_ms": float(np.percentile(np.asarray(lat_a) * 1e3, 99)),
        "p50_b_ms": float(np.percentile(np.asarray(lat_b) * 1e3, 50)),
        "p99_b_ms": float(np.percentile(np.asarray(lat_b) * 1e3, 99)),
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)),
        "batch_hist_a": hist_a, "batch_hist_b": hist_b,
        "sampled": int(rows.shape[0]), "decisive": int(decisive.sum()),
        "u_err": err, "u_tol": tol, "metrics_a": res_a.metrics.as_row(),
    }
    log(f"[main] warm-up {warm_s:.3f} s; fused_mlp launches {launches} = 13 x "
        f"{forwards} forwards ({len(svc._buckets.widths)} warm-up + "
        f"{stats['batches']} batches)")
    log(f"[main] (a) 1 client: {dec_a} decisions in {wall_a:.3f} s = "
        f"{out['dps_a']:.1f} decisions/s; latency p50 {out['p50_a_ms']:.3f} "
        f"ms p99 {out['p99_a_ms']:.3f} ms; batch sizes {hist_a}")
    log(f"[main] (b) 8 clients: {dec_b} decisions in {wall_b:.3f} s = "
        f"{out['dps_b']:.1f} decisions/s; latency p50 {out['p50_b_ms']:.3f} "
        f"ms p99 {out['p99_b_ms']:.3f} ms; batch sizes {hist_b}")
    log(f"[main] sampled {out['sampled']} served rows: kernel vs torch "
        f"action values max abs err {err!r} (tol {tol!r}); argmax equal on "
        f"all {out['decisive']} rows with top-2 margin > tol")
    log(f"[main] (a) ScheduleMetrics {json.dumps(res_a.metrics.as_row())}")
    return out


def phase_breakdown(agent, n_decisions: int = 300) -> dict:
    """Where one client's decision time goes: the first ``n_decisions`` of
    the (a) trace, stepped by hand at width 1 — simulator, row encoding,
    and the forward (host-to-device copy, 13 kernel launches, argmax,
    device-to-host copy and wait).  A second, identical pass under
    ``torch.profiler`` sums the device's kernel time; the busy share is
    that over the first pass's wall time (the profiler slows the host).
    Runs after the main path's launches are read."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import DecisionService, ServeConfig
    from repro_torch.sim import SimConfig, Simulator
    from repro_torch.workloads import ThetaConfig, build_scenarios

    cfg = ThetaConfig(duration_days=2.0, jobs_per_day=160.0, seed=0)
    jobs = build_scenarios(cfg, ("S1",))["S1"]
    svc = DecisionService(agent, ServeConfig(max_batch=16))
    svc.warmup()

    def steps():
        sim = Simulator(cfg.resources(), jobs, None, SimConfig.for_engine())
        t = np.zeros(3)
        n = 0
        wall0 = time.perf_counter()
        while n < n_decisions:
            t0 = time.perf_counter()
            ctx = sim.next_decision()
            t1 = time.perf_counter()
            if ctx is None:
                break
            row = svc._encode(ctx)
            t2 = time.perf_counter()
            action = svc._process([row])[0]
            t3 = time.perf_counter()
            sim.post_action(action)
            t[:] += ((t1 - t0) + (time.perf_counter() - t3), t2 - t1, t3 - t2)
            n += 1
        return n, time.perf_counter() - wall0, t * 1e3 / max(n, 1)

    n, wall, (sim_ms, enc_ms, fwd_ms) = steps()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps()
    # Device time of the kernels themselves: a record_function range also
    # shows up as a device-side annotation spanning its kernels.
    events = [e for e in prof.key_averages() if not e.is_user_annotation]
    kernel_ms = sum(e.self_device_time_total for e in events) / 1e3
    out = {"decisions": n, "wall_ms": wall * 1e3, "sim_ms": sim_ms,
           "encode_ms": enc_ms, "forward_ms": fwd_ms,
           "device_busy_ms": kernel_ms,
           "device_busy_share": kernel_ms / (wall * 1e3)}
    log(f"[breakdown] {n} decisions at width 1 in {wall * 1e3:.1f} ms: per "
        f"decision simulator {sim_ms:.4f} ms, encode {enc_ms:.4f} ms, "
        f"forward (copy, launches, wait) {fwd_ms:.4f} ms")
    log(f"[breakdown] device kernels (torch.profiler, second pass) "
        f"{kernel_ms:.3f} ms = busy share {out['device_busy_share']:.4f} of "
        f"the first pass's wall time")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"[breakdown]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"x{e.count:6d}  {e.key[:90]}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    from repro_torch.core import AgentConfig, MRSchAgent
    from repro_torch.nn import count_params
    from repro_torch.workloads import ThetaConfig

    t_start = time.perf_counter()
    card = phase_env()
    phase_build()
    worst_f32 = phase_parity()
    agent = MRSchAgent(ThetaConfig().resources(), AgentConfig(seed=0))
    n_params = count_params(agent.net)
    log(f"[agent] paper width: state_dim {agent.enc.state_dim}, "
        f"{n_params} parameters ({4 * n_params / 1e6:.1f} MB float32), "
        f"backend {agent.dfp.backend}")
    timing = phase_timing(agent)
    main_path = phase_main_path(agent)
    phase_breakdown(agent)
    t_k, t_p, t_l, bnd, by = timing["sums"][16]
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    kernels = {"kernels": [{
        "name": "fused_mlp_forward", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": main_path["launches"], "max_abs_err": worst_f32,
        "ms": t_k, "plain_ms": t_p, "bound_ms": bnd, "bound_by": by,
        "library_ms": t_l,
    }]}
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
