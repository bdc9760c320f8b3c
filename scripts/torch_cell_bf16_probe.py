"""Probe of the PyTorch port's one-step LSTM cell on bf16 tensors
(``ops.fused_lstm.fused_lstm_cell``, row 2b: a ``--bf16`` model's
``cell="pallas"``) on one NVIDIA card.

Run from the root of a checkout: ``python3 scripts/torch_cell_bf16_probe.py``.
Prints, on the card it finds (it fails without one):

1. the card's name and power limit;
2. the build of ``csrc/fused_serve.cu``: the bf16 cell instance's
   registers, spills and shared memory (``ptxas -v``) and its count of
   ``HMMA`` instructions in the SASS;
3. the kernel against ``lstm_cell`` on the bf16 tensors and on their f32
   widening at D_in = 3, 128 and 131 and B = 1, 257, 16383 and 16384: the
   largest gap of h and c to each;
4. at B = 16384, D_in = 3 and 128, H = 128, the call as the serve path makes
   it (the wrapper, back to back; CUDA events) in turns with
   ``torch.lstm_cell`` on the bf16 tensors (W split into w_ih and w_hh);
   each one's device time a call (``torch.profiler``) and host time a call
   (the host clock over 200 calls before the card is waited for);
5. the ``cell="pallas"`` serve call of a bf16 ``seq2seq-tf-30`` at
   B = 16384 (60 cell launches), with the card's busy time a call
   (``torch.profiler``) and the host's time to issue one.

``--f32`` prints only the f32 cell (row 2) and ``torch.lstm_cell`` on f32
tensors at B = 16384 (D_in = 3 and 128) and 262,144 (D_in = 3), in turns,
with the host's time a call, and ``seq2seq-tf-30``'s ``cell="pallas"`` and
``decode_fused`` calls at B = 16384 and 262,144; ``--checkout DIR`` imports the port (and its ``chip_smoke.py``) from
another checkout, such as an unpacked older commit, so that one call can
time both, one process a checkout (parent, change, change, parent): the
design before the tensor cores is an older checkout's.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def host_us(fn, calls=200):
    """The host's time a call: ``calls`` calls enqueued back to back, timed
    before the card is waited for (µs)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def time_f32(cs, fused_lstm, LSTMParams, dev, smi, checkout):
    """The f32 cell and torch.lstm_cell at the serve path's shapes (B =
    16384 at D_in = 3 and 128, 262,144 at 3), in turns; then the
    seq2seq-tf-30 calls on the cell at B = 16384 and 262,144: cell="pallas"
    (60 cell launches) and decode_fused (30 and one fused_decode)."""
    from longterm360fov_tpu_torch import infer, oracle
    from longterm360fov_tpu_torch.params import params_from_numpy

    for batch, d_in in ((16384, 3), (16384, 128), (262144, 3)):
        rng = np.random.default_rng(12 + d_in)
        (p,) = cs.stack(rng, dev, d_in, 1)
        x, h, c = cs.randn(rng, dev, (batch, d_in)), cs.randn(rng, dev, (batch, 128), 0.5), cs.randn(
            rng, dev, (batch, 128), 0.5)
        w_ih, w_hh = p.w[:d_in].t().contiguous(), p.w[d_in:].t().contiguous()
        b_hh = torch.zeros_like(p.b)
        fns = {"kernel": lambda: fused_lstm.fused_lstm_cell(p, x, (h, c)),
               "torch.lstm_cell": lambda: torch.lstm_cell(x, [h, c], w_ih, w_hh, p.b, b_hh)}
        with torch.inference_mode():
            ms = cs.in_turns(fns, dict.fromkeys(fns, 50 if batch == 16384 else 5))
            host = {k: host_us(f) for k, f in fns.items()}
        print(f"f32 cell (port from {checkout}), B={batch}, D_in={d_in}, H=128: a call as the serve path makes it "
              f"(ms, CUDA events, in turns; {smi}): {json.dumps(ms)}; host time a call (µs): {json.dumps(host)}",
              flush=True)
    cfg = cs.cell_cfg()
    params = params_from_numpy(oracle.init_params_np(0, cfg.model), dev)
    for batch in (16384, 262144):
        past = cs.unit_rows(np.random.default_rng(13), dev, (batch, cfg.model.h_in))
        calls = {"cell=pallas": infer.make_predict_fn(params, cfg, device=dev, impl="plain"),
                 "decode_fused": cs.decode_fused_path(params, cfg)}
        with torch.inference_mode():
            ms = cs.in_turns({k: (lambda f=f: f(past)) for k, f in calls.items()},
                             dict.fromkeys(calls, 5 if batch == 16384 else 2))
        print(f"seq2seq-tf-30 calls on the f32 cell (port from {checkout}), B={batch} (ms, CUDA events, in turns; "
              f"{smi}): {json.dumps(ms)}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", default=str(ROOT), help="the checkout whose port to import")
    ap.add_argument("--f32", action="store_true", help="only the f32 cell against torch.lstm_cell")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch sees no CUDA device; this probe runs only on the card")
    sys.path.insert(0, args.checkout)
    import chip_smoke as cs
    from longterm360fov_tpu_torch import infer, oracle
    from longterm360fov_tpu_torch.config import get_preset
    from longterm360fov_tpu_torch.models.cell import LSTMParams, lstm_cell
    from longterm360fov_tpu_torch.ops import _build, fused_lstm
    from longterm360fov_tpu_torch.params import params_from_numpy, tree_leaves, tree_unflatten

    fused_lstm.exact_f32_matmul()
    dev = torch.device("cuda:0")
    bf = torch.bfloat16
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if args.f32:
        time_f32(cs, fused_lstm, LSTMParams, dev, smi, args.checkout)
        return

    b = _build.build("fused_serve")
    sass = subprocess.run([os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump"), "-sass", str(b.path)],
                          capture_output=True, text=True, check=True).stdout
    hmma, fn = 0, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = "lstm_cell_kernel" in ln and "nv_bfloat16" in ln
        elif fn and "HMMA" in ln:
            hmma += 1
    cs.BUILD_LOGS["fused_serve"] = b.log
    res = cs.ptxas_resources("fused_serve", ("lstm_cell_kernel", "nv_bfloat16"))
    print(f"build (nvcc {b.seconds:.1f} s): lstm_cell_kernel<bf16> {hmma} HMMA instructions in its SASS; "
          f"{json.dumps(res)}", flush=True)

    def inputs(batch, d_in, seed):
        rng = np.random.default_rng(seed)
        (p,) = cs.stack(rng, dev, d_in, 1)
        x, h, c = (cs.randn(rng, dev, shape, scale).to(bf)
                   for shape, scale in (((batch, d_in), 1.0), ((batch, 128), 0.5), ((batch, 128), 0.5)))
        return LSTMParams(p.w.to(bf), p.b.to(bf)), x, h, c

    readings = {}
    for d_in in (3, 128, 131):
        for batch in (1, 257, 16383, 16384):
            p, x, h, c = inputs(batch, d_in, d_in)
            got = fused_lstm.fused_lstm_cell(p, x, (h, c))
            torch.cuda.synchronize()
            ref_bf = lstm_cell(p, x, (h, c))
            ref32 = lstm_cell(LSTMParams(p.w.float(), p.b.float()), x.float(), (h.float(), c.float()))
            readings[f"D_in={d_in} B={batch}"] = {
                "bf16": max((g.float() - r.float()).abs().max().item() for g, r in zip(got, ref_bf)),
                "f32": max((g.float() - r).abs().max().item() for g, r in zip(got, ref32)),
                "dtypes": sorted({str(g.dtype)[6:] for g in got})}
    print(f"fused_lstm_cell bf16 against lstm_cell on the bf16 tensors and on their f32 widening (largest gaps "
          f"of h and c): {json.dumps(readings)}", flush=True)

    for d_in in (3, 128):
        p, x, h, c = inputs(16384, d_in, 12 + d_in)
        w_ih, w_hh = p.w[:d_in].t().contiguous(), p.w[d_in:].t().contiguous()
        b_hh = torch.zeros_like(p.b)

        def cell():
            return fused_lstm.fused_lstm_cell(p, x, (h, c))

        fns = {"kernel": cell, "torch.lstm_cell": lambda: torch.lstm_cell(x, [h, c], w_ih, w_hh, p.b, b_hh)}
        with torch.inference_mode():
            ms = cs.in_turns(fns, dict.fromkeys(fns, 50))
            # the kernel: the mean of the profiler's records of a launch (and how many it kept of 20)
            dev_ms = {"kernel": cs.launch_device_ms(fns["kernel"], "lstm_cell_kernel", 20)}
            dev_ms["torch.lstm_cell"] = cs.device_ms(fns["torch.lstm_cell"], 20)
            host = {k: host_us(f) for k, f in fns.items()}
        print(f"B=16384, D_in={d_in}, H=128, bf16: a call as the serve path makes it (ms, CUDA events, in turns; "
              f"{smi}): {json.dumps(ms)}; device time a call (ms, torch.profiler; the kernels' as [mean of a "
              f"launch's records, records kept of 20]): {json.dumps(dev_ms)}; host time a call (µs): "
              f"{json.dumps(host)}", flush=True)

    cfg = get_preset("seq2seq-tf-30", model_cell="pallas", model_param_dtype="bfloat16")
    params = params_from_numpy(oracle.init_params_np(0, cfg.model), dev)
    bparams = tree_unflatten(params, [t.bfloat16() for t in tree_leaves(params)])
    past = cs.unit_rows(np.random.default_rng(13), dev, (16384, cfg.model.h_in))
    serve = infer.make_predict_fn(bparams, cfg, device=dev, impl="plain")

    calls = {"kernel": lambda: serve(past)}
    with torch.inference_mode():
        ms = cs.in_turns(calls, {"kernel": 10})
        # the card's busy time a call (the kernels torch.profiler records,
        # summed) and the host's time to issue a call: a call whose busy
        # time is well under its wall time waits on the host
        busy = {k: cs.device_ms(f, 5) for k, f in calls.items()}
        host = {k: host_us(f, 10) / 1e3 for k, f in calls.items()}
    print(f"seq2seq-tf-30 cell=pallas bf16 serve call at B=16384 (60 cell launches; ms, CUDA events, in turns; {smi}): "
          f"{json.dumps(ms)}, traj/s {json.dumps({k: 16384e3 / v for k, v in ms.items()})}; device busy a call "
          f"(ms, torch.profiler) {json.dumps(busy)}; host time to issue a call (ms) {json.dumps(host)}", flush=True)


if __name__ == "__main__":
    main()
