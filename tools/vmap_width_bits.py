"""Whether a client's bits on the card depend on how many clients share
its vmapped call, at ResNet18-GN's shapes (32x32 inputs, a batch of 8).

``ScaleEngine`` vmaps its clients' local phase, evolve gradients and eval
(one client a call, ``scale.engine.CLIENTS_PER_CALL``, because of what
this script shows); a convolution vmapped over K clients is one grouped
convolution of K groups.  This script compares, for K=8 stacked clients,
the result of one call over all 8 with the same clients taken ``width``
at a time (4, 2, 1), bit for bit:

* each op of the model alone, forward and backward (``torch.func.vjp``
  with a fixed cotangent): every distinct convolution shape of
  ResNet18-GN (3x3 and the 1x1 downsamples, strides 1 and 2), GroupNorm
  at each width, the head;
* the whole local phase (``scale.stacked.stacked_local_phase``) and the
  evolve gradients (``stacked_grads``) of ``simulate --scale --model
  resnet18 --hw 32 --clients 8 --batch-size 8`` from its round-0 state.

Prints one line a case: per width, bit-equal or the max abs difference
(and, for the ops, which output: 0 forward, then the parameter
gradients, last the input gradient), after the card's name and power
limit.  Card only (``setup_device("cuda")`` raises without a GPU):

    PYTHONPATH=src python3 tools/vmap_width_bits.py
"""
import subprocess

import torch

from repro_torch.device import setup_device
from repro_torch.launch import train
from repro_torch.models.cnn import _head, conv
from repro_torch.models.common import groupnorm
from repro_torch.scale.stacked import stacked_grads, stacked_local_phase
from repro_torch.utils.tree import tree_leaves, tree_map

K, BATCH = 8, 8
WIDTHS = (4, 2, 1)
# (cin, cout, hw, stride, kernel): every convolution shape of ResNet18-GN
CONVS = [(3, 64, 32, 1, 3), (64, 64, 32, 1, 3), (64, 128, 32, 2, 3),
         (64, 128, 32, 2, 1), (128, 128, 16, 1, 3), (128, 256, 16, 2, 3),
         (128, 256, 16, 2, 1), (256, 256, 8, 1, 3), (256, 512, 8, 2, 3),
         (256, 512, 8, 2, 1), (512, 512, 4, 1, 3)]
SCALE_ARGS = ["simulate", "--scale", "--model", "resnet18", "--hw", "32",
              "--clients", str(K), "--rounds", "1", "--local-epochs", "1",
              "--samples-per-class", "20", "--batch-size", str(BATCH)]


def compare(name, fn, args):
    """``fn(*args)`` (a list of K-leading tensors) against ``fn`` over the
    clients ``width`` at a time; one printed line."""
    full = fn(*args)
    parts = []
    for w in WIDTHS:
        diff, where = 0.0, None
        for k0 in range(0, K, w):
            part = fn(*[tree_map(lambda t: t[k0:k0 + w], a) for a in args])
            for i, (a, b) in enumerate(zip(full, part)):
                a = a[k0:k0 + w]
                if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                    d = float((a - b).abs().max())
                    if where is None or d > diff:
                        diff, where = d, i
        parts.append(f"width {w}: " + ("bit-equal" if where is None else
                                       f"max abs diff {diff:.3g} (output "
                                       f"{where})"))
    print(f"{name}: " + "; ".join(parts), flush=True)


def op_cases(gen):
    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    cases = []
    for cin, cout, hw, s, k in CONVS:
        cases.append((f"conv {k}x{k} {cin}->{cout} {hw}x{hw} stride {s}",
                      lambda p, x, s=s: conv(p, x, s),
                      {"w": r(K, k, k, cin, cout)}, r(K, BATCH, hw, hw, cin)))
    for c, hw in ((64, 32), (128, 16), (256, 8), (512, 4)):
        cases.append((f"groupnorm {c} {hw}x{hw}", groupnorm,
                      {"scale": r(K, c), "bias": r(K, c)},
                      r(K, BATCH, hw, hw, c)))
    cases.append(("head 512->10", _head,
                  {"fc": {"w": r(K, 512, 10), "b": r(K, 10)}},
                  r(K, BATCH, 4, 4, 512)))
    return cases


def main():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    setup_device("cuda")
    for name, op, params, x in op_cases(
            torch.Generator(device="cuda").manual_seed(0)):
        def fwd_bwd(p, x, op=op):
            out, vjp = torch.func.vjp(torch.func.vmap(op), p, x)
            gp, gx = vjp(0.37 * torch.ones_like(out) + 0.01 * out)
            return [out] + tree_leaves(gp) + [gx]

        compare(name, fwd_bwd, (params, x))
    args = train.parse_args(SCALE_ARGS)
    engine = train.build_engine(args)
    inp = engine._round_inputs(engine._make_ctx(0))
    apply_fn, opt = engine.task.apply_fn, engine._opt
    state = engine.state
    compare("local phase", lambda p, m, x, y, live: tree_leaves(
        stacked_local_phase(apply_fn, opt, p, m, x, y, live, inp["lr"])),
        (state["params"], state["masks"], inp["bx"], inp["by"], inp["live"]))
    compare("evolve gradients", lambda p, x, y: tree_leaves(
        stacked_grads(apply_fn, p, x, y)),
        (state["params"], inp["ev_x"], inp["ev_y"]))


if __name__ == "__main__":
    main()
