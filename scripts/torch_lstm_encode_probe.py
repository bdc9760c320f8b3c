"""Probe of the PyTorch port's LSTM kernels on the tensor cores
(``csrc/lstm_mma.cuh``) on one NVIDIA card: the lockstep tier's peer context
(``ops.fused_lstm.peer_context``), the whole-sequence encoder
(``ops.fused_lstm.fused_encode``) and the serve kernel
(``ops.fused_lstm.fused_serve``, rows 1 and 1b; ``fused_decode``, row 3),
all in ``csrc/fused_serve.cu``.

Run from the root of a checkout: ``python3 scripts/torch_lstm_encode_probe.py``.
``--checkout DIR`` imports the port (and its ``chip_smoke.py``) from another
checkout instead, such as an unpacked older commit; ``--self-only`` then
skips the probe build, which that checkout may lack. Prints, on the card it
finds (it fails without one):

1. the card's name and power limit, each build's registers and spills, and
   the SASS of the tensor-core kernels (``cuobjdump -sass``) by opcode: HMMA
   (tensor-core products), MUFU (the cell's exp and reciprocal), the FMA
   units' float operations, shared-memory loads and stores, barriers;
2. both encoders in both compute types against their plain versions at the
   card tests' shapes (``tests/test_torch_kernel_cuda.py``): the largest
   absolute gap to the plain version of the same tier (and, in bf16, to
   the f32 one), and whether a repeat is bit-equal;
3. times, CUDA events, in turns (``chip_smoke.in_turns``): the peer context
   at ``stacked-ss-crossuser-10s``'s serving shape (B = 4096 and 65,536,
   K = 7, T = 100, C = 128) and the encoder at ``stacked-ss-crossuser``'s
   peer rows (65,536 rows, T = 30, H = 128, one layer), in bf16 beside the
   f32 tier and, at the smaller shapes, cuDNN's ``nn.LSTM`` in bf16;
4. unless ``--self-only``: the time split of the probe build
   (``-DLSTM_PROBE``: thread 0 of every block adds its ``clock64`` deltas
   per part, ``LstmPart`` order) of the bf16 kernels at those shapes and
   of the bf16 serve kernel at row 1b's three shapes (5.);
5. with ``--serve`` only: the serve kernel alone in bf16 beside its f32
   twin, in turns, at row 1b's three shapes (``seq2seq-tf-30`` without
   context at B = 262,144; ``stacked-ss-crossuser``'s static context,
   L = 2, C = 128, at 65,536; ``stacked-ss-crossuser-10s``'s lockstep serve
   kernel fed a per-step context, 100 + 100 steps, at 65,536), and the
   serve call end to end (``chip_smoke.serve_call``: normalize, the
   kernels, denormalize, the tile mask; CUDA events) of
   ``stacked-ss-crossuser-10s`` (the peer context and the lockstep serve
   kernel) and ``stacked-ss-crossuser`` (the encoder and the static serve
   kernel) at B = 65,536 in bf16 and f32, in turns, one process a checkout,
   so that a call can run parent, change, change, parent;
6. with ``--f32`` only: the f32 tier (three-pass TF32 on ``mma.sync``:
   ``peer_context_kernel<float>``, ``fused_encode_kernel<float>``,
   ``fused_serve_kernel<*, float>``, the latter also from given states for
   ``fused_decode``). Unless ``--skip-checks``: the builds' registers and
   spills, each timed block's dynamic shared memory, the SASS by opcode,
   and the checks: the peer context, the encoder (at the card tests'
   shapes, in the blocks ``encode_tf32_rows`` picks) and the serve
   kernel's four tiers (no context, static C = 64 and 128, lockstep K = 7)
   and ``fused_decode`` against their plain versions at ragged batches in
   every block the choosers take (64-row tiles, 32-row ones), each repeat
   bit-equal and each row bit-equal in a permuted batch. Then the times in
   turns (each a CUDA-event mean): the serve kernel at row 1's four shapes
   (no context B = 262,144; static C = 128 and 64, L = 2, B = 65,536; the
   lockstep serve kernel at 65,536) and row 3's (``fused_decode``, B =
   262,144, L = 1, 30 steps), the peer context at B = 4096 (beside cuDNN's
   ``nn.LSTM`` in f32, TF32 off) and 65,536, the encoder (row 4) at
   ``stacked-ss-crossuser``'s peer rows, 65,536 (beside cuDNN's ``nn.LSTM``
   in f32 and row 5's forward, ``ops.lstm_train.lstm_fwd``: the serve
   body's training mode from zero states with its residual stores, on bf16
   residuals) and 262,144, and three serve calls end to end
   (``seq2seq-tf-30`` at B = 262,144, ``stacked-ss-crossuser`` and
   ``stacked-ss-crossuser-10s`` at 65,536). With ``--checkout DIR
   --skip-checks``, another checkout's f32 tier at the same shapes, one
   process a checkout. Unless ``--self-only``: the f32 probe build's split
   at row 1's shapes and the encoder's.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
PARTS = ("stage x or ctx", "products", "cell", "publish", "barriers", "feedback", "given states")
# the card tests' shapes: peer context (batch, K, T, C), encoder (rows, layers, hidden)
PEER_SHAPES = ((1, 7, 20, 128), (13, 3, 20, 128), (4099, 7, 20, 128), (4099, 8, 20, 128), (257, 4, 20, 64),
               (257, 8, 20, 96), (300, 1, 20, 32))
ENC_SHAPES = ((1, 1, 128), (257, 2, 128), (16387, 1, 128), (4099, 3, 128), (300, 1, 32), (300, 2, 256))
# row 1's four shapes of the f32 serve kernel: (label, preset, batch)
F32_SERVE = (("no context B=262144", "seq2seq-tf-30", 262144),
             ("static context C=128 B=65536", "stacked-ss-crossuser", 65536),
             ("static context C=64 B=65536", "video-fusion", 65536),
             ("lockstep serve kernel B=65536", "stacked-ss-crossuser-10s", 65536))


def sass_opcodes(lib_path):
    """The static instruction counts of the tensor-core peer context,
    encoder and serve kernels of both tiers in a build's SASS: in all, and
    by opcode class."""
    from longterm360fov_tpu_torch.ops import _build

    sass = subprocess.run([str(Path(_build.find_nvcc()).parent / "cuobjdump"), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    classes = {"HMMA": ("HMMA",), "MUFU": ("MUFU",), "FMA units": ("FFMA", "FMUL", "FADD", "FSEL", "FSETP", "FMNMX"),
               "LDS/LDSM": ("LDS", "LDSM"), "STS": ("STS",), "global": ("LDG", "STG", "LD.", "ST."), "BAR": ("BAR",)}
    counts, fn = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            names = ("peer_context_kernel", "fused_encode_kernel", "fused_serve_kernel")
            fn = next((n for n in names if n in ln), None)
            if fn == "fused_serve_kernel":
                fn += "<true>" if "ILb1E" in ln else "<false>"
            if fn:
                fn += "<bf16>" if "nv_bfloat16" in ln else "<f32>"
                counts[fn] = dict.fromkeys(["all", *classes], 0)
        elif fn and "/*" in ln and ";" in ln:
            op = ln.split("*/")[1].strip().split()[0] if "*/" in ln else ""
            op = op.split()[0] if op else ""
            if op.startswith("@"):
                op = ln.split("*/")[1].split()[1]
            counts[fn]["all"] += 1
            for name, prefixes in classes.items():
                if op.startswith(prefixes):
                    counts[fn][name] += 1
    return counts


def serve_shapes(chip_smoke, dev):
    """Row 1b's three shapes of the serve kernel: "<shape> <tier>" → a call
    of the kernel (``fused_lstm._launch_serve``, on the library that
    ``fused_lstm._library`` gives when it runs) on the tier's weights, for
    the bf16 tier and its f32 twin."""
    from longterm360fov_tpu_torch import cli, windows
    from longterm360fov_tpu_torch.config import get_preset
    from longterm360fov_tpu_torch.ops import fused_lstm
    from longterm360fov_tpu_torch.params import params_from_numpy

    bf, shapes = torch.bfloat16, {}
    for label, preset, batch in (("no context B=262144", "seq2seq-tf-30", 262144),
                                 ("static context B=65536", "stacked-ss-crossuser", 65536),
                                 ("lockstep serve kernel B=65536", "stacked-ss-crossuser-10s", 65536)):
        cfg = get_preset(preset)
        m = cfg.model
        params = params_from_numpy(cli.bench_params_np(cfg, 0), dev)
        rng = np.random.default_rng(1)
        x = windows.normalize_window(chip_smoke.unit_rows(rng, dev, (batch, m.h_in)))[0].contiguous()
        ctx, step = None, bool(m.peer_align)
        if m.ctx_dim:  # the lockstep tier's per-step context, or a static one
            ctx = chip_smoke.randn(rng, dev, (batch, m.h_out, m.ctx_dim) if step else (batch, m.ctx_dim), 0.3)
        for cd in (bf, torch.float32):
            enc, dec = fused_lstm._in_tier(params["encoder"], cd), fused_lstm._in_tier(params["decoder"], cd)
            pw, pb = params["proj"]["w"].to(cd).contiguous(), params["proj"]["b"].float()
            shapes[f"{label} {str(cd)[6:]}"] = (lambda enc=enc, dec=dec, pw=pw, pb=pb, x=x, ctx=ctx, step=step, cd=cd,
                                                t=m.h_out: fused_lstm._launch_serve(enc, dec, pw, pb, x, t, ctx,
                                                                                    step_ctx=step, compute_dtype=cd))
    return shapes


def time_serve(chip_smoke, dev, smi):
    """The serve kernel alone and the serve calls of the two crossuser
    presets (5. above)."""
    from longterm360fov_tpu_torch import cli
    from longterm360fov_tpu_torch.config import get_preset
    from longterm360fov_tpu_torch.models import cross_user
    from longterm360fov_tpu_torch.params import params_from_numpy

    shapes = serve_shapes(chip_smoke, dev)
    for label in {k.rsplit(" ", 1)[0] for k in shapes}:
        fns = {cd: shapes[f"{label} {cd}"] for cd in ("bfloat16", "float32")}
        with torch.inference_mode():
            ms = chip_smoke.in_turns(fns, dict.fromkeys(fns, 2))
        print(f"the serve kernel alone, {label} (ms, CUDA events, in turns; {smi}): {json.dumps(ms)}", flush=True)
    del shapes
    torch.cuda.empty_cache()
    out = {}
    for preset, iters in (("stacked-ss-crossuser-10s", 1), ("stacked-ss-crossuser", 3)):
        cfg = get_preset(preset)
        params = params_from_numpy(cli.bench_params_np(cfg, 0), dev)
        calls = {str(cd)[6:]: chip_smoke.serve_call(cfg, params, dev, 65536, cd, cross_user)
                 for cd in (torch.float32, torch.bfloat16)}
        out[preset] = chip_smoke.in_turns(calls, dict.fromkeys(calls, iters))
        torch.cuda.empty_cache()
    print(f"serve calls at B=65536 (ms a call, CUDA events, in turns; {smi}): {json.dumps(out)}", flush=True)


def top_opcodes(lib_path, symbol, n=20):
    """The ``n`` most frequent SASS opcodes of the kernel whose mangled name
    holds ``symbol``, with their static counts."""
    from collections import Counter

    from longterm360fov_tpu_torch.ops import _build

    sass = subprocess.run([str(Path(_build.find_nvcc()).parent / "cuobjdump"), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    counts, inside = Counter(), False
    for ln in sass.splitlines():
        if "Function :" in ln:
            inside = symbol in ln
        elif inside and "/*" in ln and ";" in ln and "*/" in ln:
            words = ln.split("*/")[1].split()
            if words:
                counts[words[1] if words[0].startswith("@") and len(words) > 1 else words[0]] += 1
    return dict(counts.most_common(n))


def f32_calls(chip_smoke, dev):
    """The f32 tier's timed calls: "<kernel> <shape>" → a call through the
    port's wrappers (``fused_lstm._launch_serve`` for the serve kernel
    alone, on the library that ``fused_lstm._library`` gives when it runs),
    and cuDNN's ``nn.LSTM`` in f32 beside the peer context at B = 4096."""
    from longterm360fov_tpu_torch import cli, windows
    from longterm360fov_tpu_torch.config import get_preset
    from longterm360fov_tpu_torch.models import cross_user, seq2seq
    from longterm360fov_tpu_torch.ops import fused_lstm, lstm_train
    from longterm360fov_tpu_torch.params import params_from_numpy

    f32, calls = torch.float32, {}
    for label, preset, batch in F32_SERVE:
        cfg = get_preset(preset)
        m = cfg.model
        params = params_from_numpy(cli.bench_params_np(cfg, 0), dev)
        rng = np.random.default_rng(1)
        x = windows.normalize_window(chip_smoke.unit_rows(rng, dev, (batch, m.h_in)))[0].contiguous()
        ctx, step = None, bool(m.peer_align)
        if m.ctx_dim:  # the lockstep tier's per-step context, or a static one
            ctx = chip_smoke.randn(rng, dev, (batch, m.h_out, m.ctx_dim) if step else (batch, m.ctx_dim), 0.3)
        args = (params["encoder"], params["decoder"], params["proj"]["w"], params["proj"]["b"], x, m.h_out, ctx)
        calls[f"fused_serve {label}"] = (lambda args=args, step=step: fused_lstm._launch_serve(
            *args, step_ctx=step, compute_dtype=f32))
        if preset == "seq2seq-tf-30":  # row 3: the decoder alone from given states
            states = [chip_smoke.randn(rng, dev, (1, batch, m.hidden), 0.3) for _ in range(2)]
            y0 = chip_smoke.randn(rng, dev, (batch, m.d), 0.1)
            dargs = (params["decoder"], params["proj"]["w"], params["proj"]["b"], *states, y0, m.h_out)
            calls[f"fused_decode B={batch} L=1 30 steps"] = lambda dargs=dargs: fused_lstm.fused_decode(*dargs)
            calls[f"serve call seq2seq-tf-30 B={batch}"] = chip_smoke.serve_call(cfg, params, dev, batch, f32, seq2seq)
        if preset == "stacked-ss-crossuser":  # row 4: the encoder at the peer rows of B = 16384 and 65,536
            (peer,) = [params["peer_encoder"]]
            for rows in (65536, 262144):
                xs = chip_smoke.unit_rows(rng, dev, (rows, m.h_out))
                calls[f"fused_encode {rows} rows"] = lambda xs=xs, peer=peer: fused_lstm.fused_encode([peer], xs)
                if rows == 65536:
                    zero = torch.zeros((1, rows, m.ctx_dim), device=dev)
                    calls[f"lstm_fwd {rows} rows"] = (lambda xs=xs, peer=peer, zero=zero: lstm_train.lstm_fwd(
                        [peer], xs, zero, zero, torch.bfloat16))
                    net = chip_smoke.cudnn_lstm([peer], 3, dev, training=False, dtype=f32)

                    def library(net=net, xs=xs):
                        with torch.no_grad():
                            return net(xs)[1][0][-1]
                    calls[f"cudnn_f32 {rows} rows"] = library
            calls[f"serve call {preset} B={batch}"] = chip_smoke.serve_call(cfg, params, dev, batch, f32, cross_user)
        if step:
            peer = params["peer_encoder"]
            for pb in (4096, 65536):
                pxs, w = chip_smoke.peer_inputs(rng, dev, chip_smoke.randn(rng, dev, (pb, 1, 3)), cfg.n_other_users,
                                                m.h_out)
                calls[f"peer_context B={pb}"] = (lambda pxs=pxs, w=w, peer=peer: fused_lstm.peer_context(peer, pxs, w))
                if pb == 4096:
                    net = chip_smoke.cudnn_lstm([peer], 3, dev, training=False, dtype=f32)
                    flat = pxs.reshape(-1, m.h_out, 3)

                    def library(net=net, flat=flat):
                        with torch.no_grad():
                            return net(flat)[0]
                    calls[f"cudnn_f32 B={pb}"] = library
            calls[f"serve call {preset} B={batch}"] = chip_smoke.serve_call(cfg, params, dev, batch, f32, cross_user)
    return calls


def f32_checks(chip_smoke, dev):
    """The f32 tier against its plain versions (6. above) → {case: reading}."""
    from longterm360fov_tpu_torch.ops import fused_lstm

    def gap(a, b):
        return round((a - b).abs().max().item(), 9)

    def perm_of(n):
        return torch.randperm(n, generator=torch.Generator().manual_seed(n)).to(dev)

    readings = {}
    peer_choose, choose = fused_lstm.peer_tf32_rows, fused_lstm.serve_tf32_rows
    for rows in (0, 32):
        for batch, k, t, c in PEER_SHAPES:
            rng = np.random.default_rng(batch + k)
            peer = chip_smoke.stack(rng, dev, 3, 1, h=c)[0]
            pxs, w = chip_smoke.peer_inputs(rng, dev, chip_smoke.randn(rng, dev, (batch, 1, 3)), k, t)
            with mock.patch.object(fused_lstm, "peer_tf32_rows", lambda *a, **kw: peer_choose(*a, rows=rows, **kw)):
                out = fused_lstm.peer_context(peer, pxs, w)
                perm = perm_of(batch)
                readings[f"peer_context B={batch} K={k} T={t} C={c} rows={rows or 'chosen'}"] = {
                    "gap": gap(out, fused_lstm.peer_context_reference(peer, pxs, w)),
                    "repeat_bit_equal": torch.equal(out, fused_lstm.peer_context(peer, pxs, w)),
                    "permuted_bit_equal": torch.equal(out[perm], fused_lstm.peer_context(peer, pxs[perm].contiguous(),
                                                                                        w[perm].contiguous()))}
        for batch in (1, 4099):
            for layers, ctx_dim, tier in ((1, 0, "none"), (2, 64, "static"), (2, 128, "static"), (1, 12, "static"),
                                          (2, 128, "lockstep")):
                rng = np.random.default_rng(layers + ctx_dim)
                enc, dec = chip_smoke.stack(rng, dev, 3, layers), chip_smoke.stack(rng, dev, 3 + ctx_dim, layers)
                pw, pb = chip_smoke.randn(rng, dev, (128, 3), 0.1), chip_smoke.randn(rng, dev, (3,), 0.1)
                t_out = 25 if tier == "lockstep" else 30
                x = chip_smoke.randn(rng, dev, (batch, 30, 3), 0.1)
                kw = {"context": chip_smoke.randn(rng, dev, (batch, ctx_dim))} if tier == "static" else {}
                if tier == "lockstep":
                    peer = chip_smoke.stack(rng, dev, 3, 1, h=ctx_dim)[0]
                    pxs, w = chip_smoke.peer_inputs(rng, dev, x, 7, t_out)
                    kw = dict(peer_params=peer, peer_xs=pxs, peer_w=w)
                with mock.patch.object(fused_lstm, "serve_tf32_rows",
                                       lambda *a, **k_: choose(*a, rows=rows, **k_)):
                    def call(x=x, kw=kw):
                        return fused_lstm.fused_serve(enc, dec, pw, pb, x, t_out, **kw)
                    out = call()
                    perm = perm_of(batch)
                    pkw = {k_: v[perm].contiguous() if k_ != "peer_params" else v for k_, v in kw.items()}
                    readings[f"fused_serve {tier} B={batch} L={layers} C={ctx_dim} rows={rows or 'chosen'}"] = {
                        "gap": gap(out, fused_lstm.fused_serve_reference(enc, dec, pw, pb, x, t_out, **kw)),
                        "repeat_bit_equal": torch.equal(out, call()),
                        "permuted_bit_equal": torch.equal(out[perm], call(x[perm].contiguous(), pkw))}
                    if tier == "lockstep":
                        continue
                    states = [chip_smoke.randn(rng, dev, (layers, batch, 128), 0.3) for _ in range(2)]
                    y0 = chip_smoke.randn(rng, dev, (batch, 3), 0.1)
                    ctx = kw.get("context")
                    dec_out = fused_lstm.fused_decode(dec, pw, pb, *states, y0, 30, context=ctx)
                    ref = fused_lstm.fused_decode_reference(dec, pw, pb, *states, y0, 30, ctx)
                    pst = [s_[:, perm].contiguous() for s_ in states]
                    readings[f"fused_decode B={batch} L={layers} C={ctx_dim} rows={rows or 'chosen'}"] = {
                        "gap": gap(dec_out, ref),
                        "repeat_bit_equal": torch.equal(dec_out, fused_lstm.fused_decode(dec, pw, pb, *states, y0, 30,
                                                                                         context=ctx)),
                        "permuted_bit_equal": torch.equal(dec_out[perm], fused_lstm.fused_decode(
                            dec, pw, pb, *pst, y0[perm].contiguous(), 30,
                            context=None if ctx is None else ctx[perm].contiguous()))}
    for rows, layers, h in ENC_SHAPES:  # row 4 in the blocks encode_tf32_rows picks
        rng = np.random.default_rng(rows + layers)
        ps = chip_smoke.stack(rng, dev, 3, layers, h=h)
        xs = chip_smoke.randn(rng, dev, (rows, 30, 3), 0.3)
        out = fused_lstm.fused_encode(ps, xs)
        perm = perm_of(rows)
        readings[f"fused_encode rows={rows} L={layers} H={h}"] = {
            "gap": gap(out, fused_lstm.fused_encode_reference(ps, xs)),
            "repeat_bit_equal": torch.equal(out, fused_lstm.fused_encode(ps, xs)),
            "permuted_bit_equal": torch.equal(out[perm], fused_lstm.fused_encode(ps, xs[perm].contiguous()))}
    return readings


def f32_mode(chip_smoke, dev, smi, args):
    """6. above."""
    from longterm360fov_tpu_torch.config import get_preset
    from longterm360fov_tpu_torch.ops import _build, fused_lstm

    builds = {}
    if not args.skip_checks:
        with ThreadPoolExecutor(max_workers=2) as pool:  # one nvcc each, started together
            jobs = {"fused_serve": pool.submit(_build.build, "fused_serve")}
            if not args.self_only:
                jobs["probe"] = pool.submit(_build.build, "fused_serve", ("LSTM_PROBE",))
            builds = {k: j.result() for k, j in jobs.items()}
        for k, b in builds.items():
            print(f"build {k}: {b.seconds:.1f} s; {chip_smoke.ptxas_report(b.log)}", flush=True)
        print(f"SASS instructions of the tensor-core kernels by opcode: "
              f"{json.dumps(sass_opcodes(builds['fused_serve'].path))}", flush=True)
        print(f"the f32 lockstep serve kernel's most frequent SASS opcodes: "
              f"{json.dumps(top_opcodes(builds['fused_serve'].path, 'fused_serve_kernelILb1EfE'))}", flush=True)
        blocks = {label: fused_lstm.serve_tf32_rows(m.hidden, m.layers, m.d, m.ctx_dim, bool(m.peer_align))
                  for label, m in ((label, get_preset(preset).model) for label, preset, _ in F32_SERVE)}
        blocks["peer_context K=7 C=128"] = fused_lstm.peer_tf32_rows(128, 7, 3)
        blocks["fused_encode L=1 H=128"] = fused_lstm.encode_tf32_rows(128, 1, 3)
        shapes = {k: [g.rp, g.mt, g.warps, g.c_smem, g.smem] for k, g in blocks.items()}
        print(f"f32 blocks at the timed shapes (rows, m16 tiles a warp tile, warps, c in shared memory, bytes of "
              f"dynamic shared memory): {json.dumps(shapes)}", flush=True)
        readings = f32_checks(chip_smoke, dev)
        worst = {kind: max((r["gap"] for n, r in readings.items() if n.startswith(kind)), default=0.0)
                 for kind in ("peer_context", "fused_encode", "fused_serve", "fused_decode")}
        equal = all(r["repeat_bit_equal"] and r["permuted_bit_equal"] for r in readings.values())
        print(f"f32 tier against plain (largest absolute gap; gates: peer_context and fused_encode "
              f"{chip_smoke.ENC_TOL}, the serve kernel and fused_decode {chip_smoke.KERNEL_TOL}): worst "
              f"{json.dumps(worst)}, every repeat and permuted batch bit-equal: {equal}; {json.dumps(readings)}",
              flush=True)
    calls = f32_calls(chip_smoke, dev)
    with torch.inference_mode():
        for fn in calls.values():
            fn()
        torch.cuda.synchronize()
        iters = {k: 1 if ("65536" in k and "static" not in k and "rows" not in k) or "serve call" in k
                 or "262144 rows" in k else 3 for k in calls}
        ms = chip_smoke.in_turns(calls, iters)
    print(f"f32 tier times (ms a call, CUDA events, in turns; port from {args.checkout}; {smi}): {json.dumps(ms)}",
          flush=True)
    if args.self_only or args.skip_checks:
        return
    del calls
    torch.cuda.empty_cache()
    lib = fused_lstm.bind(ctypes.CDLL(str(builds["probe"].path)))
    buf = (ctypes.c_ulonglong * len(PARTS))()
    with mock.patch.object(fused_lstm, "_library", lambda: lib):
        probe_calls = {k: v for k, v in f32_calls(chip_smoke, dev).items()
                       if k.startswith(("fused_serve", "fused_decode", "peer_context", "fused_encode"))}
        for name, fn in probe_calls.items():
            fn()
            torch.cuda.synchronize()
            lib.fused_serve_probe_read(buf)
            t_ms = chip_smoke.cuda_ms(fn, 1)
            lib.fused_serve_probe_read(buf)
            total = sum(buf)
            split = {p: round(v / total, 4) for p, v in zip(PARTS, buf) if v}
            print(f"{name} f32 probe build ({t_ms:.3f} ms a call, {total / 2:.0f} clocks a call summed over the "
                  f"blocks; thread 0's clock64 a part; {smi}): {json.dumps(split)}", flush=True)


def _with_lib(fused_lstm, lib, fn):
    with mock.patch.object(fused_lstm, "_library", lambda: lib):
        return fn()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", default=str(ROOT), help="the checkout whose port to import")
    ap.add_argument("--self-only", action="store_true", help="skip the probe build")
    ap.add_argument("--serve", action="store_true", help="only time the serve calls")
    ap.add_argument("--f32", action="store_true", help="the f32 tier: checks, times, split")
    ap.add_argument("--skip-checks", action="store_true", help="with --f32: only the times")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch sees no CUDA device; this probe runs only on the card")
    sys.path.insert(0, args.checkout)
    import chip_smoke
    from longterm360fov_tpu_torch.ops import _build, fused_lstm

    fused_lstm.exact_f32_matmul()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{smi}; port from {args.checkout}", flush=True)
    dev = torch.device("cuda:0")
    bf, f32 = torch.bfloat16, torch.float32
    if args.serve:
        return time_serve(chip_smoke, dev, smi)
    if args.f32:
        return f32_mode(chip_smoke, dev, smi, args)
    with ThreadPoolExecutor(max_workers=2) as pool:  # one nvcc each, started together
        jobs = {"fused_serve": pool.submit(_build.build, "fused_serve")}
        if not args.self_only:
            jobs["probe"] = pool.submit(_build.build, "fused_serve", ("LSTM_PROBE",))
        builds = {k: j.result() for k, j in jobs.items()}
    for k, b in builds.items():
        print(f"build {k}: {b.seconds:.1f} s; {chip_smoke.ptxas_report(b.log)}", flush=True)
    print(f"SASS instructions of the bf16 kernels by opcode: {json.dumps(sass_opcodes(builds['fused_serve'].path))}",
          flush=True)

    def gaps(out, refs):
        return [round((out - r).abs().max().item(), 7) for r in refs]

    readings = {}
    for batch, k, t, c in PEER_SHAPES:
        rng = np.random.default_rng(batch + k)
        peer = chip_smoke.stack(rng, dev, 3, 1, h=c)[0]
        pxs, w = chip_smoke.peer_inputs(rng, dev, chip_smoke.randn(rng, dev, (batch, 1, 3)), k, t)
        for cd in (f32, bf):
            out = fused_lstm.peer_context(peer, pxs, w, compute_dtype=cd)
            refs = [fused_lstm.peer_context_reference(peer, pxs, w, c_) for c_ in ((cd,) if cd == f32 else (bf, f32))]
            readings[f"peer_context B={batch} K={k} T={t} C={c} {str(cd)[6:]}"] = {
                "gap": gaps(out, refs), "repeat_bit_equal": torch.equal(out, fused_lstm.peer_context(
                    peer, pxs, w, compute_dtype=cd))}
    for rows, layers, h in ENC_SHAPES:
        rng = np.random.default_rng(rows + layers)
        ps = chip_smoke.stack(rng, dev, 3, layers, h=h)
        xs = chip_smoke.randn(rng, dev, (rows, 30, 3), 0.3)
        for cd in (f32, bf):
            out = fused_lstm.fused_encode(ps, xs, compute_dtype=cd)
            refs = [fused_lstm.fused_encode_reference(ps, xs, c_) for c_ in ((cd,) if cd == f32 else (bf, f32))]
            readings[f"fused_encode rows={rows} L={layers} H={h} {str(cd)[6:]}"] = {
                "gap": gaps(out, refs), "repeat_bit_equal": torch.equal(out, fused_lstm.fused_encode(
                    ps, xs, compute_dtype=cd))}
    print(f"against plain (largest absolute gap to the plain version of the tier, and in bf16 to f32): "
          f"{json.dumps(readings)}", flush=True)

    rng = np.random.default_rng(2)
    peer = chip_smoke.stack(rng, dev, 3, 1)[0]
    (tier_peer,) = fused_lstm._in_tier([peer], bf)
    cases = {}
    for batch in (4096, 65536):
        pxs, w = chip_smoke.peer_inputs(rng, dev, chip_smoke.randn(rng, dev, (batch, 1, 3)), 7, 100)
        cases[batch] = (pxs, w)
        fns = {"bf16": lambda: fused_lstm.peer_context(peer, pxs, w, compute_dtype=bf),
               "f32": lambda: fused_lstm.peer_context(peer, pxs, w)}
        if batch == 4096:
            net, flat = chip_smoke.cudnn_lstm([peer], 3, dev, training=False, dtype=bf), pxs.reshape(-1, 100, 3).to(bf)

            def library():
                with torch.no_grad():
                    return net(flat)[0]
            fns["cudnn_bf16"] = library
        it = 3 if batch == 4096 else 1
        ms = chip_smoke.in_turns(fns, dict.fromkeys(fns, it))
        print(f"peer_context alone at B={batch}, K=7, T=100, C=128 (ms, CUDA events, in turns; cudnn_bf16: "
              f"nn.LSTM in bf16 over the {batch * 7} peer rows; {smi}): {json.dumps(ms)}", flush=True)
    ps = chip_smoke.stack(rng, dev, 3, 1)
    tier_ps = fused_lstm._in_tier(ps, bf)
    xs = chip_smoke.unit_rows(rng, dev, (65536, 30))
    net, xs_lib = chip_smoke.cudnn_lstm(ps, 3, dev, training=False, dtype=bf), xs.to(bf)

    def library():
        with torch.no_grad():
            return net(xs_lib)[1][0][-1]
    fns = {"bf16": lambda: fused_lstm.fused_encode(ps, xs, compute_dtype=bf), "f32": lambda: fused_lstm.fused_encode(
        ps, xs), "cudnn_bf16": library}
    ms = chip_smoke.in_turns(fns, dict.fromkeys(fns, 5))
    print(f"fused_encode alone at 65,536 rows, T=30, H=128, L=1 (ms, CUDA events, in turns; cudnn_bf16: nn.LSTM "
          f"in bf16; {smi}): {json.dumps(ms)}", flush=True)
    del net
    torch.cuda.empty_cache()
    if args.self_only:
        return

    lib = fused_lstm.bind(ctypes.CDLL(str(builds["probe"].path)))
    buf = (ctypes.c_ulonglong * len(PARTS))()
    calls = {"peer_context B=4096": lambda: fused_lstm.launch_peer_context(lib, tier_peer, *cases[4096], bf),
             "peer_context B=65536": lambda: fused_lstm.launch_peer_context(lib, tier_peer, *cases[65536], bf),
             "fused_encode 65536 rows": lambda: fused_lstm.launch_encode(lib, tier_ps, xs, bf)}
    with mock.patch.object(fused_lstm, "_library", lambda: lib):
        serve = serve_shapes(chip_smoke, dev)  # the serve kernel on the probe build
    calls.update({f"fused_serve {k}": (lambda fn=fn: _with_lib(fused_lstm, lib, fn))
                  for k, fn in serve.items() if k.endswith("bfloat16")})
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        lib.fused_serve_probe_read(buf)
        n = 2
        t_ms = chip_smoke.cuda_ms(fn, n)
        lib.fused_serve_probe_read(buf)
        total = sum(buf)
        split = {p: round(v / total, 4) for p, v in zip(PARTS, buf) if v}
        print(f"{name} bf16 probe build ({t_ms:.3f} ms a call, {total / (n + 1):.0f} clocks a call summed over "
              f"the blocks; thread 0's clock64 a part; {smi}): {json.dumps(split)}", flush=True)


if __name__ == "__main__":
    main()
