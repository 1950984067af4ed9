"""Quickstart — attach PASTA to a training workload, on the port.

The port's ``examples/quickstart.py``, with the same steps and the same
printed lines.  One ``pasta.Session`` owns the whole pipeline: tool
selection by registry spec, framework-level instrumentation (operator
events, tensor lifetimes, fine-grained access traces reduced on the
device), ring buffering, and the compiled-step capture: one real call of
the train step, profiled (on the card: its device kernels and launch
counts, the paper's CUPTI tier), then ``session.capture_compiled``.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

import repro_torch.configs as configs
import repro_torch.core as pasta
from repro_torch.core import capture
from repro_torch.models import init_params, forward
from repro_torch.train import OptConfig, make_train_step
from repro_torch.train.optimizer import init_opt_state

TOOLS = "kernel_freq,workingset,timeline"


def run(cfg, device="cuda", seed: int = 0, steps: int = 5, observe=None):
    """Both halves of the example on ``device``.  ``observe``, when given,
    is called with the session before the forward.  Returns ``(reports,
    artifact, stats)``: the session's reports, the profiled train-step call
    and its capture rollup.  The reports are taken while the weights, the
    tokens and the logits are still alive, as in the example, whose
    ``main`` holds them to its end."""
    # float32 stays float32 on the card (cuDNN would default to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = init_params(cfg, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    x = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                      dtype=torch.int32, device=device)
    labels = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                           dtype=torch.int32, device=device)

    with pasta.Session(tools=TOOLS, instrument=True, fine=True,
                       buffered=True, name="quickstart",
                       torch_device=device) as session:
        if observe is not None:
            observe(session)
        # 1) eager instrumented pass: framework-level events batched
        #    through the SoA ring (flushed at step edges / session exit)
        with torch.inference_mode(), pasta.region("forward"):
            logits, _ = forward(params, x, cfg)

        # 2) compiled-step capture: kernel launches & collectives × steps
        opt_cfg = OptConfig()
        step = make_train_step(cfg, opt_cfg, microbatches=1)
        opt = init_opt_state(params, opt_cfg)
        artifact = capture.capture_step(step, params, opt,
                                        {"inputs": x, "labels": labels})
        stats = session.capture_compiled(artifact, label="train_step",
                                         default_trip=cfg.n_layers,
                                         steps=steps)
    reports = session.reports()
    return reports, artifact, stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = configs.reduced(configs.get("paper-gpt2"))
    reports, _artifact, _stats = run(cfg, args.device)

    print("== PASTA tool reports ==")
    kf = reports["kernel_freq"]
    print(f"kernel_freq: total={kf['total_invocations']} "
          f"distinct={kf['distinct_kernels']} top3={kf['top'][:3]}")
    ws = reports["workingset"]
    print(f"workingset: footprint={ws['footprint_mb']:.1f}MB "
          f"ws={ws['working_set_mb']:.2f}MB "
          f"median={ws['median_ws_mb']:.2f}MB")
    tl = reports["timeline"]
    d = tl["devices"][0]
    print(f"timeline: peak={tl['peak_bytes'][d]}B "
          f"allocs={tl['alloc_events'][d]} frees={tl['free_events'][d]}")
    print(reports["kernel_freq"].to_json()[:120] + "...")


if __name__ == "__main__":
    main()
