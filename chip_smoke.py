#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --profile  # phase 4 under torch.profiler only

Phases (each one that fails raises, so the script exits non-zero):

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions,
   and the nvcc build of the kernels from ``src/repro_torch/kernels/csrc``;
2. kernels: the paged chunked-prefill (K3) and paged decode (K4) CUDA
   kernels against their plain PyTorch versions on the card, at the
   paper-llama-13b, tinyllama-1.1b and qwen2-0.5b widths, in float32
   (tolerance 2e-5, TF32 off) and bfloat16 (2e-2), with ``start`` mid-block,
   a chunk length off the kernel's row tile and a poisoned scratch block 0,
   the llama-13b bf16 case timed with CUDA events beside its plain version
   and its bound; then small edge cases (block sizes 8-128, group sizes
   1-16, one-row chunks, rows past the table's end);
3. parity: tinyllama-1.1b ``.reduced()`` in float32 on the paged pool
   serves the quickstart workload; greedy tokens on the card (kernels) must
   equal those on the CPU (plain versions);
4. full width: paper-llama-13b in bfloat16 with random weights made on the
   card from a seed, behind ``Server(policy="sarathi", paged=True)``,
   serves 6 requests; every logit must be finite, and the kernels' launch
   counts over ``run()`` must equal 40 layers x the steps that need them.

The line before the last is the ``{"kernels": [...]}`` JSON; the last is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
program beside it, the script exits non-zero and prints no result.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_OPS = {"bfloat16": 989e12,    # dense tensor-core rate
            "float32": 67e12}      # outside the tensor cores (TF32 off)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SOURCE = "src/repro_torch/kernels/csrc/paged_attention.cu"
REPLACES = {
    "paged_chunked_prefill_attention":
        "src/repro/kernels/paged_chunked_prefill_attention.py:88",
    "paged_decode_attention": "src/repro/kernels/paged_decode_attention.py:95",
}
# main-path geometry (phase 4): Server(chunk_size=256, n_slots=8,
# max_len=2048, block_size=16) -> C = 256, D = 7, M = 128, 1025 blocks
C_MAIN, N_SLOTS, MAX_LEN, BS = 256, 8, 2048, 16


def log(msg=""):
    print(msg, flush=True)


def cuda_ms(fn, reps=25, warm=3):
    """Median milliseconds of ``fn()`` over ``reps`` runs, each timed with
    CUDA events after ``warm`` untimed runs."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_err(got, want, tol):
    """Max |got - want|; raises unless |got - want| <= tol * (1 + |want|)
    everywhere."""
    import torch
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError("kernel output is not finite")
    diff = (g - w).abs()
    bad = diff > tol * (1 + w.abs())
    if bad.any():
        raise AssertionError(f"{int(bad.sum())} elements off by up to "
                             f"{float(diff.max()):.3e} (tol {tol})")
    return float(diff.max())


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------
SHAPES = {  # name: (n_q_heads, n_kv_heads, head_dim)
    "paper-llama-13b": (40, 40, 128),
    "tinyllama-1.1b": (32, 4, 64),
    "qwen2-0.5b": (14, 2, 64),
}


def kernel_case(arch, dtype_name, timed):
    """One shape x dtype: build main-path-like inputs, check both kernels
    against their plain versions, optionally time them.  Returns a dict per
    kernel."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref

    nq, nk, hd = SHAPES[arch]
    dtype = getattr(torch, dtype_name)
    M = MAX_LEN // BS
    D = N_SLOTS - 1
    N = N_SLOTS * M + 1
    rng = np.random.default_rng(sum(map(ord, arch + dtype_name)))
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1e9)))
    pool = torch.randn((N, BS, 2 * nk, hd), generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)
    pool[0] = 99.0                                # poisoned scratch block
    perm = torch.from_numpy(rng.permutation(np.arange(1, N)).astype(
        np.int32)).cuda()

    # K4: D lanes, the last one an unused (scratch) lane as on the main path
    ctx = rng.integers(256, 1568, D).astype(np.int32)
    ctx[-1] = 0
    tables = torch.zeros((D, M), dtype=torch.int32, device="cuda")
    for b in range(D - 1):
        n_blk = ctx[b] // BS + 1                  # allocated blocks only
        tables[b, :n_blk] = perm[b * M: b * M + n_blk]
    ctx_t = torch.from_numpy(ctx).cuda()
    q_d = torch.randn((D, nq, hd), generator=gen, device="cuda").to(dtype)

    # K3: a chunk of C rows (off the 16-row tile) at a mid-block start
    C = C_MAIN - 6
    start = 1000 + 7
    n_blk = (start + C - 1) // BS + 1
    table = torch.zeros((M,), dtype=torch.int32, device="cuda")
    table[:n_blk] = perm[(D - 1) * M: (D - 1) * M + n_blk]
    start_t = torch.tensor(start, dtype=torch.int32, device="cuda")
    q_c = torch.randn((C, nq, hd), generator=gen, device="cuda").to(dtype)

    out = {}
    size = torch.finfo(dtype).bits // 8
    cases = {
        "paged_decode_attention": (
            lambda: ops.paged_decode_attention(q_d, pool, tables, ctx_t),
            lambda: ref.paged_decode_attention_ref(q_d, pool, tables, ctx_t),
            # bytes: q + out + the visible K/V rows + their table entries
            2 * q_d.numel() * size
            + sum(int(c) + 1 for c in ctx) * 2 * nk * hd * size
            + sum(int(c) // BS + 1 for c in ctx) * 4 + 4 * D,
            # ops: QK and PV, 2 each per (query head, visible key, dim)
            sum(4 * hd * nq * (int(c) + 1) for c in ctx)),
        "paged_chunked_prefill_attention": (
            lambda: ops.paged_chunked_prefill_attention(q_c, pool, table,
                                                        start_t),
            lambda: ref.paged_chunked_prefill_attention_ref(q_c, pool, table,
                                                            start_t),
            2 * q_c.numel() * size
            + (start + C) * 2 * nk * hd * size + n_blk * 4 + 4,
            sum(4 * hd * nq * (start + i + 1) for i in range(C))),
    }
    for name, (kern, plain, n_bytes, n_ops) in cases.items():
        before = ops.launches[name]
        got = kern()
        torch.cuda.synchronize()
        if ops.launches[name] != before + 1:
            raise AssertionError(f"{name}: the wrapper did not launch")
        err = max_err(got, plain(), TOL[dtype_name])
        row = {"max_abs_err": err,
               "bound_ms": 1e3 * max(n_bytes / HBM_BYTES_PER_S,
                                     n_ops / PEAK_OPS[dtype_name]),
               "bound_by": ("bytes" if n_bytes / HBM_BYTES_PER_S
                            >= n_ops / PEAK_OPS[dtype_name]
                            else "operations")}
        if timed:
            row["ms"] = cuda_ms(kern)
            row["plain_ms"] = cuda_ms(plain)
        out[name] = row
        log(f"  {name:33s} {arch:16s} {dtype_name:9s} max_abs_err "
            f"{err:.3e}" + (f"  kernel {row['ms']:.4f} ms  plain "
                            f"{row['plain_ms']:.4f} ms  bound "
                            f"{row['bound_ms']:.4f} ms ({row['bound_by']})"
                            if timed else ""))
    return out


def edge_cases():
    """Both kernels on small inputs around their edges, untimed: block
    sizes 8-128, group sizes 1-16, a chunk of 1 row, starts on a block
    boundary and past the table's end, contexts 0 and on block edges."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref

    n = 0
    rng = np.random.default_rng(11)
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for g, hd, bs in ((1, 128, 8), (2, 64, 32), (4, 128, 16),
                          (7, 64, 8), (16, 64, 16), (8, 128, 128)):
            nk, M, N = 2, 6, 20
            pool = torch.from_numpy(rng.standard_normal(
                (N, bs, 2 * nk, hd)).astype(np.float32)).to("cuda", dtype)
            pool[0] = 99.0
            perm = rng.permutation(np.arange(1, N)).astype(np.int32)
            ctx = np.array([0, bs - 1, bs, M * bs - 1], np.int32)
            tables = np.zeros((len(ctx), M), np.int32)
            for b, c in enumerate(ctx):
                k = c // bs + 1
                tables[b, :k] = rng.choice(perm, k, replace=False)
            q = torch.randn((len(ctx), g * nk, hd), device="cuda").to(dtype)
            args = (q, pool, torch.from_numpy(tables).cuda(),
                    torch.from_numpy(ctx).cuda())
            max_err(ops.paged_decode_attention(*args),
                    ref.paged_decode_attention_ref(*args), TOL[dtype_name])
            n += 1
            table = torch.from_numpy(perm[:M].copy()).cuda()
            for C, start in ((1, 0), (17, bs), (40, M * bs - 10)):
                q = torch.randn((C, g * nk, hd), device="cuda").to(dtype)
                st = torch.tensor(start, dtype=torch.int32, device="cuda")
                args = (q, pool, table, st)
                max_err(ops.paged_chunked_prefill_attention(*args),
                        ref.paged_chunked_prefill_attention_ref(*args),
                        TOL[dtype_name])
                n += 1
    log(f"  {n} edge cases agree (fp32 2e-5, bf16 2e-2)")


# --------------------------------------------------------------------------
# phase 3: reduced model, card == CPU
# --------------------------------------------------------------------------
def quickstart_tokens(device, params, cfg):
    import numpy as np
    from repro_torch.core import quantized_chunk_size
    from repro_torch.scheduler import Request
    from repro_torch.serving import Server

    n_slots = 4
    chunk = quantized_chunk_size(target=16, n_decodes=n_slots - 1, tile=8)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, int(n)).tolist(),
                    max_new_tokens=8) for n in (37, 21, 44, 9)]
    srv = Server(cfg, params, policy="sarathi", chunk_size=chunk,
                 n_slots=n_slots, max_len=256, paged=True, device=device)
    res = srv.run(reqs)
    return [res.outputs[r.req_id] for r in reqs]


# --------------------------------------------------------------------------
# phase 4: full width through the Server
# --------------------------------------------------------------------------
def full_width(profile=False):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.scheduler import Request
    from repro_torch.serving import Server

    cfg = get_config("paper-llama-13b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16)
    srv = Server(cfg, params, policy="sarathi", chunk_size=C_MAIN,
                 n_slots=N_SLOTS, max_len=MAX_LEN, paged=True,
                 block_size=BS, dtype=torch.bfloat16)
    eng = srv.engine
    eng.warmup()
    torch.cuda.synchronize()
    log(f"  built {cfg.name} (random bf16 weights, "
        f"{eng.block_manager.n_blocks} blocks) in "
        f"{time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")

    n_bad = torch.zeros((), dtype=torch.int64, device="cuda")
    n_logits = [0]

    def check(chunk_logits, decode_logits):
        for x in (chunk_logits, decode_logits):
            if x is not None:
                n_bad.add_((~torch.isfinite(x)).sum())
                n_logits[0] += x.shape[0]
                if x.shape[-1] != cfg.vocab_size:
                    raise AssertionError(f"logits shape {tuple(x.shape)}")

    steps = []                                   # (has_chunk, seconds)
    execute = eng.execute

    def timed_execute(plan):
        t = time.perf_counter()
        out = execute(plan)
        torch.cuda.synchronize()
        steps.append((bool(plan.chunks), time.perf_counter() - t))
        return out

    eng.on_logits = check
    eng.execute = timed_execute
    rng = np.random.default_rng(0)
    lens = rng.integers(256, 1537, 6)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, int(n)).tolist(),
                    max_new_tokens=32) for n in lens]
    ops.reset_launches()
    it0 = eng.iterations
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity
        prof = torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA])
        prof.__enter__()
    t = time.perf_counter()
    res = srv.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    if prof is not None:
        prof.__exit__(None, None, None)
        report_profile(prof, wall, eng.iterations - it0)
    launches = dict(ops.launches)
    packed = eng.iterations - it0
    with_chunk = sum(1 for c, _ in steps if c)

    if int(n_bad):
        raise AssertionError(f"{int(n_bad)} non-finite logits")
    for r in reqs:
        if len(res.outputs[r.req_id]) != 32:
            raise AssertionError(f"request {r.req_id}: "
                                 f"{len(res.outputs[r.req_id])} tokens")
    want = {"paged_decode_attention": cfg.n_layers * packed,
            "paged_chunked_prefill_attention": cfg.n_layers * with_chunk}
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}")
    hybrid = [s for c, s in steps if c]
    decode = [s for c, s in steps if not c]
    n_out = sum(len(v) for v in res.outputs.values())
    log(f"  prompts {lens.tolist()} x 32 new tokens: {len(res.iterations)} "
        f"iterations ({with_chunk} hybrid, {packed - with_chunk} decode-only)"
        f", {n_logits[0]} logit rows all finite")
    log(f"  median hybrid step {1e3 * statistics.median(hybrid):.3f} ms, "
        f"median decode-only step {1e3 * statistics.median(decode):.3f} ms, "
        f"{n_out / wall:.1f} output tokens/s ({wall:.2f} s run)")
    log(f"  launches over run(): {launches} (= {cfg.n_layers} layers x "
        f"{packed} packed steps / {with_chunk} steps with a chunk)")
    del srv, eng, params
    torch.cuda.empty_cache()
    return launches


def report_profile(prof, wall, n_steps):
    """Device time by kernel over the profiled run, and the device's busy
    share of the (profiler-slowed) wall time."""
    from torch.autograd import DeviceType
    events = prof.key_averages()
    # device-side events only: an aten op's row repeats its kernels' time
    dev = sorted(((e.self_device_time_total, e.count, e.key)
                  for e in events if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0), reverse=True)
    busy_us = sum(t for t, _, _ in dev)
    log(f"  profiled: {n_steps} steps in {1e3 * wall:.1f} ms wall, device "
        f"busy {busy_us / 1e3:.1f} ms ({100 * busy_us / 1e6 / wall:.1f}%), "
        f"{sum(c for _, c, _ in dev)} device ops")
    for t, c, k in dev[:15]:
        log(f"    {t / 1e3:9.2f} ms {c:7d}x  {k[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== 1. card and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    from repro_torch.kernels import build
    t = time.perf_counter()
    reports = build.build_all()
    log(f"kernels built in {time.perf_counter() - t:.1f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    if "--profile" in sys.argv[1:]:
        log("== profile: paper-llama-13b bf16 run() under torch.profiler")
        full_width(profile=True)
        return 0

    log("== 2. kernels vs plain versions (poisoned scratch block 0)")
    main_row = None
    for arch in SHAPES:
        for dt in ("float32", "bfloat16"):
            timed = arch == "paper-llama-13b" and dt == "bfloat16"
            rows = kernel_case(arch, dt, timed)
            if timed:
                main_row = rows
            torch.cuda.empty_cache()
    edge_cases()

    log("== 3. reduced tinyllama, paged, float32: card == CPU")
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config("tinyllama-1.1b").reduced()
    on_cpu = quickstart_tokens("cpu", init_params(cfg, 0, device="cpu"), cfg)
    on_gpu = quickstart_tokens("cuda", init_params(cfg, 0, device="cpu")
                               .to("cuda"), cfg)
    if on_cpu != on_gpu:
        raise AssertionError(f"greedy tokens differ:\n cpu {on_cpu}\n "
                             f"cuda {on_gpu}")
    log(f"  greedy tokens equal for {len(on_cpu)} requests: {on_gpu}")

    log("== 4. paper-llama-13b bf16, Server(sarathi, paged), full width")
    launches = full_width()

    kernels = []
    for name in ("paged_chunked_prefill_attention", "paged_decode_attention"):
        r = main_row[name]
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[name],
                        "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
