#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --profile  # phases 4 (captured) and 6 under
                                     # torch.profiler only

Phases (each one that fails raises, so the script exits non-zero):

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions,
   the nvcc build of the kernels from ``src/repro_torch/kernels/csrc``, and
   ``cuobjdump -sass`` of the built libraries: the bf16 prefill kernels
   (K1, K3) must issue tensor-core instructions (HMMA);
2. kernels: the paged chunked-prefill (K3) and paged decode (K4) CUDA
   kernels against their plain PyTorch versions on the card, at the
   paper-llama-13b, stablelm-12b (head dim 160), tinyllama-1.1b and
   qwen2-0.5b widths, in float32 (tolerance 2e-5, TF32 off) and bfloat16
   (2e-2), with ``start`` mid-block, a chunk length off the kernel's row
   tile and a poisoned scratch block 0, the llama-13b and stablelm-12b
   bf16 cases timed with CUDA events beside their plain versions and their
   bounds, warm (the same inputs again) and cold (L2 flushed before each
   run); then small edge cases (block sizes 8-128, group sizes 1-16, head
   dims 64-160, one-row chunks, rows past the table's end);
3. parity: tinyllama-1.1b ``.reduced()`` in float32 on the paged pool
   serves the quickstart workload under ``sarathi``, and a shared-prefix
   workload (more requests than slots, one prompt repeated after its first
   copy finished) under ``sarathi_serve`` with ``prefix_cache=True``;
   greedy tokens on the CPU (plain versions), on the card eager
   (``graphs=False``) and on the card captured (CUDA graphs) must be
   equal, and the prefix run must reuse cached tokens and fork at least
   one block copy-on-write;
4. full width: paper-llama-13b in bfloat16 with random weights made on the
   card from a seed, behind ``Server(policy="sarathi", paged=True)``,
   serves 6 requests twice, eager and then captured: every logit must be
   finite, the kernels' launch counts over ``run()`` must equal 40 layers
   x the packed steps that need them in both runs, and the greedy tokens
   of the two runs must be identical; each run logs its median hybrid and
   decode-only step, its median host time a step (from ``execute``'s start
   until the replay, or the eager enqueue, returns, before the sync) and
   its output tokens/s;
5. dense-row kernels at their own entry points (no serving path calls
   them, as in the JAX package): the chunked-prefill (K1) and decode (K2)
   CUDA kernels against their plain versions at every shape of
   ``tests/test_kernels.py`` (head dims 64-256, groups 1-16) and at head
   dim 160, in float32 (2e-5, TF32 off) and bfloat16 (2e-2), each also
   with a stale tail poisoned with +-99 past every row's visible keys, and
   at the paper-llama-13b and stablelm-12b widths (bf16, K1: C = 256 at
   start 768 in a row of 2048; K2: 4 rows of 2048), timed warm and cold
   beside their plain versions, their bounds and one
   ``scaled_dot_product_attention`` call each;
6. ``forward_batched`` at full width: phase 4's weights, 4 prompts of 1024
   tokens, a batched prefill and 16 batched greedy decode steps on
   4 x 2048 cache rows, timed with CUDA events; every logit finite;
7. the paper's Fig. 6 claim: paper-llama-13b cut to 4 layers, float32,
   TF32 off: the last logits of a prefill in chunks of 384, 256 and 384
   equal the full prefill's within rtol = atol = 5e-4;
8. stablelm-12b (head dim 160, g 4) in bfloat16 at full width and depth,
   random weights from a seed, behind ``Server(policy="sarathi",
   paged=True)`` on phase 4's workload, eager and then captured: every
   logit finite, launch counts 40 layers x the steps that need each
   kernel; whether the two runs' tokens agree is logged;
9. prefix caching at full width: paper-llama-13b in bfloat16 behind
   ``Server(policy="sarathi_serve", paged=True, prefix_cache=True)``,
   eager and then captured, serves 16 requests on one shared 1024-token prefix with
   64-512 unique tokens each, the 16th repeating the 9th's prompt: every
   logit finite, cached tokens > 0, at least one copy-on-write pair,
   launch counts 40 layers x the packed sub-steps (a multi-chunk plan runs
   several); then the same workload with the cache off, and how many
   requests' tokens agree (reported: in bf16 a hit moves the chunk
   boundaries).

The line before the last is the ``{"kernels": [...]}`` JSON; the last is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
program beside it, the script exits non-zero and prints no result.
"""
import gc
import json
import re
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
CSRC = "src/repro_torch/kernels/csrc/"
SOURCE = {
    "paged_chunked_prefill_attention": CSRC + "paged_attention.cu",
    "paged_decode_attention": CSRC + "paged_attention.cu",
    "chunked_prefill_attention": CSRC + "dense_attention.cu",
    "decode_attention": CSRC + "dense_attention.cu",
}
REPLACES = {
    "paged_chunked_prefill_attention":
        "src/repro/kernels/paged_chunked_prefill_attention.py:88",
    "paged_decode_attention": "src/repro/kernels/paged_decode_attention.py:95",
    "chunked_prefill_attention":
        "src/repro/kernels/chunked_prefill_attention.py:57",
    "decode_attention": "src/repro/kernels/decode_attention.py:49",
}
# main-path geometry (phase 4): Server(chunk_size=256, n_slots=8,
# max_len=2048, block_size=16) -> C = 256, D = 7, M = 128, 1025 blocks
C_MAIN, N_SLOTS, MAX_LEN, BS = 256, 8, 2048, 16


def log(msg=""):
    print(msg, flush=True)


def cuda_ms(fn, reps=25, warm=3, cold=False):
    """Median milliseconds of ``fn()`` over ``reps`` runs, each timed with
    CUDA events after ``warm`` untimed runs.  Before each run (outside the
    timed span) the device spins for ~0.5 ms, so that the host has queued
    the run before the device reaches it and the span holds device time
    only, not the host's launch latency.  ``cold``: a 256 MiB buffer is
    also zeroed there, so that the run finds none of its inputs in the
    50 MB L2."""
    import torch
    flush = (torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
             if cold else None)
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        if cold:
            flush.zero_()
        torch.cuda._sleep(1_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def timings(kern, plain, library=None):
    """Warm and cold medians of a kernel, its plain version and (where
    there is one) its library call."""
    row = {}
    for key, fn in (("ms", kern), ("plain_ms", plain),
                    ("library_ms", library)):
        if fn is not None:
            row[key] = cuda_ms(fn)
            row[key + "_cold"] = cuda_ms(fn, cold=True)
    return row


def timing_text(row):
    """The timed numbers of a row, for the log."""
    text = (f"  kernel {row['ms']:.4f} ms (cold {row['ms_cold']:.4f})  "
            f"plain {row['plain_ms']:.4f} (cold {row['plain_ms_cold']:.4f})"
            f"  bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    if "library_ms" in row:
        text += (f"  sdpa {row['library_ms']:.4f} (cold "
                 f"{row['library_ms_cold']:.4f})")
    return text


def split_sweep(kern):
    """Warm ms of a decode kernel with its split forced to 1, 2, 4 and 8
    (the wrapper's rule replaced for these runs), for the log: the rule's
    choice against its neighbours."""
    from repro_torch.kernels import launch
    rule = launch.decode_split
    times = []
    try:
        for n in (1, 2, 4, 8):
            launch.decode_split = (lambda cap, nb, sms, n=n:
                                   (n, -(-cap // n)))
            times.append(f"{n}: {cuda_ms(kern):.4f}")
    finally:
        launch.decode_split = rule
    return "    forced n_split " + ", ".join(times) + " ms"


def n_split(capacity, n_blocks):
    """The decode kernels' split of rows of ``capacity`` keys over
    ``n_blocks`` = B x nk blocks on this card."""
    import torch
    from repro_torch.kernels import launch
    return launch.decode_split(capacity, n_blocks,
                               launch.sm_count(torch.device("cuda")))[0]


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
    "stablelm-12b": (32, 8, 160),
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
            row.update(timings(kern, plain))
        out[name] = row
        split = (f"  n_split {n_split(M * BS, D * nk)}"
                 if name == "paged_decode_attention" else "")
        log(f"  {name:33s} {arch:16s} {dtype_name:9s} max_abs_err "
            f"{err:.3e}" + (timing_text(row) if timed else "") + split)
        if timed and split:
            log(split_sweep(kern))
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
                          (7, 64, 8), (16, 64, 16), (8, 128, 128),
                          (1, 160, 8), (4, 160, 16), (16, 160, 32)):
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


def kernel_label(mangled):
    """``decode_kernel<bf16,128,4>`` for a kernel's mangled name."""
    for m in re.finditer(r"(\d+)(?=[A-Za-z_])", mangled):
        at = m.end()
        name = mangled[at:at + int(m.group(1))]
        rest = mangled[at + len(name):]
        if name.endswith("_kernel") and rest.startswith("I"):
            args = rest[1:rest.index("EEv")] + "E"
            return name + "<" + ",".join(
                "bf16" if t.group(0)[0] == "1" else
                "f32" if t.group(0) == "f" else t.group(1)
                for t in re.finditer(r"13__nv_bfloat16|Li(\d+)E|f",
                                     args)) + ">"
    return mangled


def ptxas_lines(report):
    """(kernel, registers, spilled bytes) for each kernel in nvcc's
    ``-Xptxas -v`` report."""
    out, kernel, spill = [], None, 0
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = kernel_label(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            out.append((kernel, int(m.group(1)), spill))
    return out


def tensor_core_check():
    """``cuobjdump -sass`` of the built libraries: HMMA instructions per
    bf16 prefill kernel (K1, K3); raises where one has none."""
    from repro_torch.kernels import build
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    counts = {}
    for name in build.SIGNATURES:
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(build._target(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        fn = None
        for line in sass.splitlines():
            if "Function : " in line:
                fn = line.split("Function : ")[1].strip()
                counts[fn] = 0
            elif fn is not None and "HMMA" in line:
                counts[fn] += 1
    mma = {f: n for f, n in counts.items() if "prefill_mma_kernel" in f}
    for f in sorted(mma):
        log(f"  {kernel_label(f)}: {mma[f]} HMMA")
    if len(mma) != 7 or not all(mma.values()):   # K1: 4 head dims, K3: 3
        raise AssertionError(f"bf16 prefill kernels without HMMA: {mma}")
    others = sum(n for f, n in counts.items() if f not in mma)
    log(f"  {len(counts) - len(mma)} other kernels: {others} HMMA")


# --------------------------------------------------------------------------
# step instrumentation (phases 3, 4, 8 and 9)
# --------------------------------------------------------------------------
class StepLog:
    """Wraps an engine's ``execute`` (the step's time, ending in a
    synchronize) and, per packed sub-step, its ``_execute_packed`` and
    ``_run`` (the sub-step's host time: from its start until the replay,
    or the eager enqueue, returns, before any sync), its ``_apply_cow``
    (copy-on-write pairs) and, with ``keep_logits``, keeps a device copy
    of every sub-step's logits; with ``scheduler``, also times each
    ``next_plan`` (the host's planning between steps)."""

    def __init__(self, eng, keep_logits=False, sync=True, scheduler=None):
        import torch
        self.steps = []          # (has_chunk, step s, sub-steps)
        self.host = []           # per sub-step, s
        self.plan = []           # per next_plan call, s
        self.cow_pairs = 0
        self.logits = []         # per sub-step: [rows, V] on the device
        execute, packed = eng.execute, eng._execute_packed
        run, cow = eng._run, eng._apply_cow
        started = []

        def timed_execute(plan):
            n = len(self.host)
            t = time.perf_counter()
            out = execute(plan)
            if sync:
                torch.cuda.synchronize()
            self.steps.append((bool(plan.chunks), time.perf_counter() - t,
                               len(self.host) - n))
            return out

        def timed_packed(*args, **kw):
            started.append(time.perf_counter())
            return packed(*args, **kw)

        def timed_run(shape):
            out = run(shape)
            self.host.append(time.perf_counter() - started.pop())
            if keep_logits:
                self.logits.append(torch.cat(
                    [x.float() for x in out if x is not None]))
            return out

        def counted_cow(pairs):
            self.cow_pairs += len(pairs)
            cow(pairs)

        eng.execute, eng._execute_packed = timed_execute, timed_packed
        eng._run, eng._apply_cow = timed_run, counted_cow
        if scheduler is not None:
            next_plan = scheduler.next_plan

            def timed_plan(*args, **kw):
                t = time.perf_counter()
                out = next_plan(*args, **kw)
                self.plan.append(time.perf_counter() - t)
                return out

            scheduler.next_plan = timed_plan

    def medians_ms(self):
        """Medians in ms: hybrid step, decode-only step, host time a
        sub-step, planning an iteration."""
        def med(xs):
            return 1e3 * statistics.median(xs) if xs else float("nan")
        return (med([s for c, s, _ in self.steps if c]),
                med([s for c, s, _ in self.steps if not c]),
                med(self.host), med(self.plan))


# --------------------------------------------------------------------------
# phase 3: reduced model, card == CPU, eager == captured
# --------------------------------------------------------------------------
def reduced_run(device, params, cfg, policy, graphs=True):
    """The reduced model on the paged pool: the quickstart workload under
    ``sarathi``; under ``sarathi_serve`` with the prefix cache, six
    requests on two shared 32-token prefixes through 3 slots, the sixth
    repeating the second's 48-token prompt (a whole number of blocks, so
    its hit is trimmed and its tail block forked).  Returns (greedy tokens,
    cached tokens, copy-on-write pairs)."""
    import numpy as np
    from repro_torch.core import quantized_chunk_size
    from repro_torch.scheduler import Request
    from repro_torch.serving import Server

    rng = np.random.default_rng(0)
    if policy == "sarathi":
        n_slots, kw = 4, {}
        reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, int(n))
                        .tolist(), max_new_tokens=8)
                for n in (37, 21, 44, 9)]
    else:
        n_slots, kw = 3, dict(prefix_cache=True)
        shared = [rng.integers(0, cfg.vocab_size, 32).tolist()
                  for _ in range(2)]
        prompts = [shared[i % 2] + rng.integers(0, cfg.vocab_size, int(n))
                   .tolist() for i, n in enumerate((5, 16, 3, 8, 6))]
        prompts.append(list(prompts[1]))
        reqs = [Request(prompt=p, max_new_tokens=6) for p in prompts]
    chunk = quantized_chunk_size(target=16, n_decodes=n_slots - 1, tile=8)
    srv = Server(cfg, params, policy=policy, chunk_size=chunk,
                 n_slots=n_slots, max_len=256, paged=True, block_size=16,
                 device=device, **kw)
    srv.engine.graphs = srv.engine.graphs and graphs
    steps = StepLog(srv.engine, sync=device != "cpu")
    res = srv.run(reqs)
    return ([res.outputs[r.req_id] for r in reqs],
            getattr(srv.scheduler, "n_cached_tokens", 0), steps.cow_pairs)


def three_way(cfg, policy):
    """Greedy tokens of the reduced run on the CPU, on the card eager and
    on the card captured must be equal."""
    from repro_torch.models import init_params
    cpu = reduced_run("cpu", init_params(cfg, 0, device="cpu"), cfg, policy)
    params = init_params(cfg, 0, device="cpu").to("cuda")
    eager = reduced_run("cuda", params, cfg, policy, graphs=False)
    graph = reduced_run("cuda", params, cfg, policy)
    if not cpu[0] == eager[0] == graph[0]:
        raise AssertionError(f"{policy}: greedy tokens differ:\n cpu "
                             f"{cpu[0]}\n eager {eager[0]}\n captured "
                             f"{graph[0]}")
    if cpu[1:] != eager[1:] or cpu[1:] != graph[1:]:
        raise AssertionError(f"{policy}: cached tokens / CoW pairs differ: "
                             f"{cpu[1:]} {eager[1:]} {graph[1:]}")
    if policy != "sarathi" and not (graph[1] > 0 and graph[2] >= 1):
        raise AssertionError(f"{policy}: {graph[1]} cached tokens, "
                             f"{graph[2]} copy-on-write pairs")
    log(f"  {policy}: greedy tokens equal on the CPU, the card eager and "
        f"the card captured for {len(cpu[0])} requests; cached tokens "
        f"{graph[1]}, copy-on-write pairs {graph[2]}: {graph[0]}")


# --------------------------------------------------------------------------
# phases 4, 8 and 9: full width through the Server
# --------------------------------------------------------------------------
def serve_full_width(cfg, params, reqs, graphs=True, profile=False,
                     keep_logits=False, **server_kw):
    """Serve ``reqs`` at full width in bf16 on the paged pool: every logit
    finite, every request its tokens, the kernels' launches 40 layers x
    the packed sub-steps that need each.  Returns a dict of the run."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving import Server

    kw = dict(policy="sarathi", chunk_size=C_MAIN, n_slots=N_SLOTS,
              max_len=MAX_LEN, paged=True, block_size=BS,
              dtype=torch.bfloat16)
    kw.update(server_kw)
    t0 = time.perf_counter()
    srv = Server(cfg, params, **kw)
    eng = srv.engine
    eng.graphs = eng.graphs and graphs
    eng.warmup()
    torch.cuda.synchronize()
    log(f"  {'captured' if graphs else 'eager'}: built the engine "
        f"({eng.block_manager.n_blocks} blocks) and warmed up in "
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

    eng.on_logits = check
    steps = StepLog(eng, keep_logits=keep_logits, scheduler=srv.scheduler)
    ops.reset_launches()
    it0 = eng.iterations
    t = time.perf_counter()
    if profile:
        res = profiled(lambda: srv.run(reqs))
    else:
        res = srv.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(ops.launches)
    sub_steps = eng.iterations - it0
    with_chunk = sum(n for c, _, n in steps.steps if c)
    if sum(n for _, _, n in steps.steps) != sub_steps:
        raise AssertionError("sub-steps miscounted")

    if int(n_bad):
        raise AssertionError(f"{int(n_bad)} non-finite logits")
    for r in reqs:
        if len(res.outputs[r.req_id]) != r.max_new_tokens:
            raise AssertionError(f"request {r.req_id}: "
                                 f"{len(res.outputs[r.req_id])} tokens")
    want = {"paged_decode_attention": cfg.n_layers * sub_steps,
            "paged_chunked_prefill_attention": cfg.n_layers * with_chunk,
            # no serving path runs the dense-row kernels, as in JAX
            "chunked_prefill_attention": 0, "decode_attention": 0}
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}")
    hybrid_ms, decode_ms, host_ms, plan_ms = steps.medians_ms()
    n_out = sum(len(v) for v in res.outputs.values())
    n_hybrid = sum(1 for c, _, _ in steps.steps if c)
    log(f"  {len(reqs)} requests: {len(res.iterations)} iterations "
        f"({n_hybrid} with a chunk, {len(res.iterations) - n_hybrid} "
        f"decode-only) in {sub_steps} packed sub-steps, {n_logits[0]} logit "
        f"rows all finite")
    log(f"  median hybrid step {hybrid_ms:.3f} ms, median decode-only step "
        f"{decode_ms:.3f} ms, median host time a sub-step {host_ms:.3f} ms, "
        f"{n_out / wall:.1f} output tokens/s ({wall:.2f} s run: "
        f"{sum(s for _, s, _ in steps.steps):.2f} s in steps, "
        f"{sum(steps.plan):.2f} s planning, median {plan_ms:.3f} ms a "
        f"plan)")
    log(f"  launches over run(): {launches} (= {cfg.n_layers} layers x "
        f"{sub_steps} packed sub-steps / {with_chunk} with a chunk)")
    out = {"outputs": [res.outputs[r.req_id] for r in reqs],
           "launches": launches, "logits": steps.logits,
           "cow_pairs": steps.cow_pairs,
           "cached": getattr(srv.scheduler, "n_cached_tokens", 0)}
    del srv, eng, steps
    gc.collect()                  # the engine's pool (a reference cycle)
    torch.cuda.empty_cache()
    return out


def main_path_requests(vocab):
    """Phase 4's workload: 6 prompts of 256-1536 tokens, 32 new tokens."""
    import numpy as np
    from repro_torch.scheduler import Request
    rng = np.random.default_rng(0)
    lens = rng.integers(256, 1537, 6)
    return [Request(prompt=rng.integers(0, vocab, int(n)).tolist(),
                    max_new_tokens=32) for n in lens]


def full_width(arch="paper-llama-13b", profile=False, require_equal=True):
    """Phase 4's workload at full width, eager (``graphs=False``) and then
    captured on the same card; the greedy tokens of the two must be
    identical (``require_equal``; else their agreement is logged).
    Returns the captured run's launches and the weights."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = get_config(arch)
    params = init_params(cfg, seed=0, dtype=torch.bfloat16)
    log(f"  {cfg.name}: random bf16 weights from seed 0")
    if profile:
        run = serve_full_width(cfg, params, main_path_requests(
            cfg.vocab_size), profile=True)
        return run["launches"], params
    eager = serve_full_width(cfg, params, main_path_requests(cfg.vocab_size),
                             graphs=False, keep_logits=True)
    graph = serve_full_width(cfg, params, main_path_requests(cfg.vocab_size),
                             keep_logits=True)
    compare_runs(eager, graph, require_equal)
    return graph["launches"], params


def compare_runs(eager, graph, require_equal=True):
    """Compare the two runs' greedy tokens, naming the first sub-step
    whose argmax differs and the largest logit gap up to it; raise if
    they differ and ``require_equal``."""
    import torch
    gap, first = 0.0, None
    for i, (a, b) in enumerate(zip(eager["logits"], graph["logits"])):
        gap = max(gap, float((a - b).abs().max()))
        if first is None and not torch.equal(a.argmax(-1), b.argmax(-1)):
            first = i
            break
    if eager["outputs"] != graph["outputs"]:
        same = sum(a == b for a, b in zip(eager["outputs"],
                                          graph["outputs"]))
        msg = (f"captured tokens differ from eager in "
               f"{len(graph['outputs']) - same} requests: first differing "
               f"sub-step {first}, largest logit gap up to it {gap:.4e}")
        if require_equal:
            raise AssertionError(msg)
        log("  " + msg)
        return
    log(f"  captured == eager: greedy tokens identical for "
        f"{len(graph['outputs'])} requests; largest logit gap {gap:.4e} "
        f"over {len(graph['logits'])} sub-steps")


def prefix_requests(vocab):
    """Phase 9's workload: 16 requests on one shared 1024-token prefix with
    64-512 unique tokens each (whole blocks), the 16th repeating the 9th's
    prompt, 32 new tokens each."""
    import numpy as np
    from repro_torch.scheduler import Request
    rng = np.random.default_rng(1)
    shared = rng.integers(0, vocab, 1024).tolist()
    prompts = [shared + rng.integers(0, vocab, BS * int(n)).tolist()
               for n in rng.integers(64 // BS, 512 // BS + 1, 15)]
    prompts.append(list(prompts[8]))
    return [Request(prompt=p, max_new_tokens=32) for p in prompts]


def prefix_full_width():
    """Phase 9: paper-llama-13b bf16 through Server(sarathi_serve,
    prefix_cache=True), eager and then captured (whether their tokens
    agree is logged); then the same workload with the cache off,
    captured, and the count of requests whose tokens agree with the
    cache on."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = get_config("paper-llama-13b")
    params = init_params(cfg, seed=0, dtype=torch.bfloat16)
    kw = dict(policy="sarathi_serve")
    eager = serve_full_width(cfg, params, prefix_requests(cfg.vocab_size),
                             graphs=False, keep_logits=True,
                             prefix_cache=True, **kw)
    on = serve_full_width(cfg, params, prefix_requests(cfg.vocab_size),
                          keep_logits=True, prefix_cache=True, **kw)
    compare_runs(eager, on, require_equal=False)
    del eager
    on["logits"].clear()
    if not (on["cached"] > 0 and on["cow_pairs"] >= 1):
        raise AssertionError(f"{on['cached']} cached tokens, "
                             f"{on['cow_pairs']} copy-on-write pairs")
    log(f"  cache on: {on['cached']} cached prompt tokens, "
        f"{on['cow_pairs']} copy-on-write pairs")
    log("  the same workload with prefix_cache=False:")
    off = serve_full_width(cfg, params, prefix_requests(cfg.vocab_size),
                           **kw)
    same = sum(a == b for a, b in zip(on["outputs"], off["outputs"]))
    log(f"  {same} of {len(on['outputs'])} requests' greedy tokens equal "
        f"with the cache on and off (bf16: a hit moves the chunk "
        f"boundaries, so this is reported, not required)")


# --------------------------------------------------------------------------
# phase 5: K1 / K2 at their own entry points
# --------------------------------------------------------------------------
K1_SHAPES = [  # tests/test_kernels.py: C, S, nq, nk, hd, start
    (128, 256, 4, 4, 64, 0), (128, 512, 8, 2, 64, 128),
    (256, 1024, 16, 8, 128, 640), (128, 128, 4, 1, 256, 0),
    (128, 384, 14, 2, 64, 200),
    (128, 384, 32, 8, 160, 200), (128, 256, 16, 1, 160, 0)]   # head dim 160
K2_SHAPES = [  # tests/test_kernels.py: B, S, nq, nk, hd
    (4, 512, 8, 2, 64), (2, 256, 4, 4, 128), (3, 384, 16, 1, 64),
    (1, 128, 14, 2, 64),
    (3, 512, 32, 8, 160), (2, 256, 16, 1, 160)]   # head dim 160
# full width (timed): paper-llama-13b heads (the kernels line's row), then
# stablelm-12b's; a 256-row chunk at 768 / 4 decodes
K1_FULL = [(256, 2048, 40, 40, 128, 768), (256, 2048, 32, 8, 160, 768)]
K2_FULL = [(4, 2048, 40, 40, 128), (4, 2048, 32, 8, 160)]


def dense_case(name, shape, dtype_name, gen, rng, timed):
    """One K1 (``chunked_prefill_attention``) or K2 (``decode_attention``)
    case: the kernel on clean inputs and on inputs whose keys past every
    row's visible ones are poisoned (K +99, V -99) against the plain
    version on the clean inputs; timed, also the plain version, the bound
    and one ``scaled_dot_product_attention`` call.  Returns a row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    dtype = getattr(torch, dtype_name)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    size = torch.finfo(dtype).bits // 8
    if name == "chunked_prefill_attention":
        C, S, nq, nk, hd, start = shape
        q, k, v = randn(C, nq, hd), randn(S, nk, hd), randn(S, nk, hd)
        start_t = torch.tensor(start, dtype=torch.int32, device="cuda")
        kp, vp = k.clone(), v.clone()
        kp[start + C:], vp[start + C:] = 99.0, -99.0

        def kern(k=k, v=v):
            return ops.chunked_prefill_attention(q, k, v, start_t)

        def plain():
            return ref.chunked_prefill_attention_ref(q, k, v, start_t)

        pos = start + torch.arange(C, device="cuda")
        mask = torch.arange(S, device="cuda")[None] <= pos[:, None]
        sq, sk, sv = (t.transpose(0, 1)[None] for t in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=mask, enable_gqa=True)[0] \
                .transpose(0, 1)

        n_keys = start + C                     # K/V rows any row sees
        n_ops = sum(4 * hd * nq * (start + i + 1) for i in range(C))
        n_int = 4
    else:
        B, S, nq, nk, hd = shape
        q = randn(B, nq, hd)
        k, v = randn(B, S, nk, hd), randn(B, S, nk, hd)
        ctx = rng.integers(S // 8, S, B).astype("int32")
        ctx_t = torch.from_numpy(ctx).cuda()
        kp, vp = k.clone(), v.clone()
        for b, c in enumerate(ctx):
            kp[b, c + 1:], vp[b, c + 1:] = 99.0, -99.0

        def kern(k=k, v=v):
            return ops.decode_attention(q, k, v, ctx_t)

        def plain():
            return ref.decode_attention_ref(q, k, v, ctx_t)

        mask = (torch.arange(S, device="cuda")[None] <= ctx_t[:, None].long()
                )[:, None, None]
        sq, sk, sv = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)

        def library():
            return F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=mask, enable_gqa=True)[:, :, 0]

        n_keys = sum(int(c) + 1 for c in ctx)
        n_ops = sum(4 * hd * nq * (int(c) + 1) for c in ctx)
        n_int = 4 * B
    want = plain()
    tol = TOL[dtype_name]
    err = max(max_err(kern(), want, tol), max_err(kern(kp, vp), want, tol))
    # bytes: q + out + the visible K/V rows + start / ctx
    n_bytes = 2 * q.numel() * size + n_keys * 2 * nk * hd * size + n_int
    row = {"max_abs_err": err,
           "bound_ms": 1e3 * max(n_bytes / HBM_BYTES_PER_S,
                                 n_ops / PEAK_OPS[dtype_name]),
           "bound_by": ("bytes" if n_bytes / HBM_BYTES_PER_S
                        >= n_ops / PEAK_OPS[dtype_name] else "operations")}
    if timed:
        max_err(library(), want, tol)          # the yardstick computes it
        row.update(timings(kern, plain, library))
    split = (f"  n_split {n_split(S, B * nk)}"
             if name == "decode_attention" else "")
    log(f"  {name:26s} {str(shape):30s} {dtype_name:9s} max_abs_err "
        f"{err:.3e}" + (timing_text(row) if timed else "") + split)
    if timed and split:
        log(split_sweep(kern))
    return row


def dense_kernels():
    """Phase 5; returns the full-width row of each kernel and the launch
    counts over the phase."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops

    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ops.reset_launches()
    rows = {}
    for name, shapes, full in (
            ("chunked_prefill_attention", K1_SHAPES, K1_FULL),
            ("decode_attention", K2_SHAPES, K2_FULL)):
        for dt in ("float32", "bfloat16"):
            for shape in shapes + full:
                timed = shape in full and dt == "bfloat16"
                row = dense_case(name, shape, dt, gen, rng, timed)
                if shape == full[0] and timed:
                    rows[name] = row
    launches = dict(ops.launches)
    for name in rows:
        if not launches[name]:
            raise AssertionError(f"{name}: no launch in phase 5")
    return rows, launches


# --------------------------------------------------------------------------
# phases 6 and 7: forward_batched at full width, and the Fig. 6 claim
# --------------------------------------------------------------------------
N_PROMPTS, PROMPT_LEN, N_DECODE = 4, 1024, 16


def prompts(vocab):
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, vocab, (N_PROMPTS, PROMPT_LEN))
                            .astype(np.int32)).cuda()


def batched_full_width(cfg, params, profile=False):
    """A batched prefill and N_DECODE batched greedy decode steps, timed
    with CUDA events (``profile``: each of the two under torch.profiler
    instead)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    model = build_model(cfg)
    toks = prompts(cfg.vocab_size)
    cache = model.init_cache(rows=N_PROMPTS, max_len=MAX_LEN,
                             dtype=torch.bfloat16)

    def offsets(n):
        return torch.full((N_PROMPTS,), n, dtype=torch.int32, device="cuda")

    def finite(x, shape):
        if tuple(x.shape) != shape or not torch.isfinite(x).all():
            raise AssertionError(f"logits {tuple(x.shape)} not finite or "
                                 f"not {shape}")

    def prefill():
        return model.forward_batched(params, toks, cache, offsets(0),
                                     logits_mode="last")[0]

    def decode(logits):
        """Greedy steps from the prefill's logits; each step's ms."""
        steps = []
        for i in range(N_DECODE):
            tok = logits.argmax(-1, keepdim=True).to(torch.int32)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            logits = model.forward_batched(params, tok, cache,
                                           offsets(PROMPT_LEN + i),
                                           logits_mode="last")[0]
            b.record()
            b.synchronize()
            steps.append(a.elapsed_time(b))
            finite(logits, (N_PROMPTS, cfg.vocab_size))
        return steps

    ops.reset_launches()
    with torch.inference_mode():
        logits = prefill()
        finite(logits, (N_PROMPTS, cfg.vocab_size))
        if profile:
            log("  one prefill:")
            profiled(prefill)
            log(f"  {N_DECODE} decode steps:")
            profiled(lambda: decode(logits))
            return
        prefill_ms = cuda_ms(prefill, reps=3, warm=0)   # rewrites the same KV
        steps = decode(logits)
    if any(ops.launches.values()):
        raise AssertionError(f"forward_batched launched {ops.launches}")
    log(f"  {N_PROMPTS} x {PROMPT_LEN}-token prefill {prefill_ms:.3f} ms "
        f"(median of 3), {N_DECODE} decode steps: median "
        f"{statistics.median(steps):.3f} ms, min {min(steps):.3f}, max "
        f"{max(steps):.3f}; all logits finite; no kernel launched (plain "
        f"attention, as in JAX)")


def fig6_check():
    """Chunked (384, 256, 384) == full prefill at float32; returns max
    |difference| of the last logits."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, init_params

    cfg = dataclasses.replace(get_config("paper-llama-13b"), n_layers=4)
    params = init_params(cfg, seed=0, dtype=torch.float32)
    model = build_model(cfg)
    toks = prompts(cfg.vocab_size)

    def prefill(spans):
        cache = model.init_cache(rows=N_PROMPTS, max_len=MAX_LEN)
        for c0, c1 in spans:
            start = torch.full((N_PROMPTS,), c0, dtype=torch.int32,
                               device="cuda")
            last = model.forward_batched(params, toks[:, c0:c1], cache,
                                         start, logits_mode="last")[0]
        return last

    with torch.inference_mode():
        full = prefill([(0, PROMPT_LEN)])
        chunked = prefill([(0, 384), (384, 640), (640, PROMPT_LEN)])
    diff = (chunked - full).abs()
    bad = diff > 5e-4 + 5e-4 * full.abs()
    if bad.any() or not torch.isfinite(full).all():
        raise AssertionError(f"chunked != full prefill: {int(bad.sum())} "
                             f"logits off, max |diff| {float(diff.max())}")
    log(f"  {cfg.n_layers} layers, {N_PROMPTS} x {PROMPT_LEN} tokens: "
        f"max |chunked - full| {float(diff.max()):.3e} over "
        f"{full.numel()} last logits (max |logit| "
        f"{float(full.abs().max()):.3f}); rtol = atol = 5e-4 hold")
    return float(diff.max())


def profiled(fn):
    """``fn()`` under torch.profiler; logs the device time by kernel and
    the device's busy share of the (profiler-slowed) wall time, and
    returns what ``fn`` returned."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    events = prof.key_averages()
    # device-side events only: an aten op's row repeats its kernels' time
    dev = sorted(((e.self_device_time_total, e.count, e.key)
                  for e in events if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0), reverse=True)
    busy_us = sum(t for t, _, _ in dev)
    log(f"  profiled: {1e3 * wall:.1f} ms wall, device "
        f"busy {busy_us / 1e3:.1f} ms ({100 * busy_us / 1e6 / wall:.1f}%), "
        f"{sum(c for _, c, _ in dev)} device ops")
    for t, c, k in dev[:15]:
        log(f"    {t / 1e3:9.2f} ms {c:7d}x  {k[:90]}")
    return out


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
        for kernel, regs, spill in ptxas_lines(report):
            log(f"  {name}: {kernel:32s} {regs:3d} registers, {spill} bytes "
                "spilled")
    tensor_core_check()

    if "--profile" in sys.argv[1:]:
        from repro_torch.configs import get_config
        log("== profile: paper-llama-13b bf16 run() under torch.profiler")
        _, params = full_width(profile=True)
        gc.collect()
        torch.cuda.empty_cache()
        log("== profile: paper-llama-13b bf16 forward_batched under "
            "torch.profiler")
        batched_full_width(get_config("paper-llama-13b"), params,
                           profile=True)
        return 0

    log("== 2. kernels vs plain versions (poisoned scratch block 0)")
    main_row = None
    for arch in SHAPES:
        for dt in ("float32", "bfloat16"):
            timed = (arch in ("paper-llama-13b", "stablelm-12b")
                     and dt == "bfloat16")
            rows = kernel_case(arch, dt, timed)
            if timed and arch == "paper-llama-13b":
                main_row = rows
            torch.cuda.empty_cache()
    edge_cases()

    log("== 3. reduced tinyllama, paged, float32: CPU == card eager == "
        "card captured")
    from repro_torch.configs import get_config
    cfg = get_config("tinyllama-1.1b").reduced()
    three_way(cfg, "sarathi")
    three_way(cfg, "sarathi_serve")

    log("== 4. paper-llama-13b bf16, Server(sarathi, paged), full width, "
        "eager then captured")
    launches, params = full_width()

    log("== 5. K1/K2 at their entry points vs plain versions (stale tails "
        "poisoned)")
    dense_rows, dense_launches = dense_kernels()
    log(f"  launches over phase 5: {dense_launches}")
    main_row.update(dense_rows)
    launches.update({n: dense_launches[n] for n in dense_rows})

    log("== 6. paper-llama-13b bf16, forward_batched, full width")
    batched_full_width(get_config("paper-llama-13b"), params)
    del params
    torch.cuda.empty_cache()

    log("== 7. Fig. 6: chunked == full prefill, paper-llama-13b x 4 layers, "
        "float32")
    fig6_check()
    gc.collect()
    torch.cuda.empty_cache()

    log("== 8. stablelm-12b bf16 (head dim 160), Server(sarathi, paged), "
        "full width, eager then captured")
    full_width("stablelm-12b", require_equal=False)
    gc.collect()
    torch.cuda.empty_cache()

    log("== 9. paper-llama-13b bf16, Server(sarathi_serve, paged, "
        "prefix_cache=True), full width, eager then captured")
    prefix_full_width()

    kernels = []
    for name in REPLACES:
        r = main_row[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCE[name], "replaces": REPLACES[name],
                        "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r.get("library_ms"),
                        "ms_cold": r["ms_cold"],
                        "plain_ms_cold": r["plain_ms_cold"],
                        "library_ms_cold": r.get("library_ms_cold")})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
