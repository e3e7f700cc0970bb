"""How far Adam's float32 bias corrections move the fraud MLP's second
step, on the CPU alone.

``chip_smoke.py``'s ``fraud_vs_cpu`` phase holds two Adam steps of the
fraud MLP (batch 16,384, f32) on the card against the CPU. The port builds
the card's Adam ``capturable`` (so that a fused group captures as a CUDA
graph): its bias corrections ``1 - beta^t`` are float32 device tensors, as
optax's are. The CPU's Adam, built with a float lr, computes them in
Python's double. This script makes the same first step both ways on the
CPU, from the smoke's weights and batches: ``torch.optim.Adam`` as the CPU
builds it, and the capturable update's arithmetic in float32. It then
reads the second step's loss and gradients at both sets of weights as the
smoke reads them (the loss relative, each parameter's gradient error
relative to its largest entry) and counts the ReLUs whose sign differs.

    python scripts/fraud_adam_bias_correction.py

Prints one JSON line.
"""

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as smoke  # noqa: E402
from analytics_zoo_tpu_torch.orca.learn.losses import \
    binary_crossentropy  # noqa: E402

LR, B1, B2, EPS = 1e-3, 0.9, 0.999, 1e-8


def loss_and_grads(state, bx, by):
    """The smoke's loss (the port's binary cross-entropy, the mean over the
    batch) and the gradients at ``state``."""
    module = smoke._fraud_net().to_module()
    module.load_state_dict(state)
    preds = module(torch.as_tensor(bx))
    loss = binary_crossentropy(torch.as_tensor(by), preds).mean()
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in module.named_parameters()}
    return float(loss.detach()), grads


def first_update_double(state, grads):
    """``torch.optim.Adam``'s first step, float lr (the CPU's build)."""
    params = {n: torch.nn.Parameter(t.clone()) for n, t in state.items()}
    opt = torch.optim.Adam(params.values(), lr=LR, betas=(B1, B2), eps=EPS)
    for n, p in params.items():
        p.grad = grads[n].clone()
    opt.step()
    return {n: p.detach().clone() for n, p in params.items()}


def first_update_float32(state, grads):
    """The capturable first step: step count, bias corrections and lr as
    float32 tensors, in the order of torch's capturable update."""
    step = torch.ones((), dtype=torch.float32)
    lr = torch.tensor(LR, dtype=torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(B1, dtype=torch.float32), step)
    bc2 = 1 - torch.pow(torch.tensor(B2, dtype=torch.float32), step)
    step_size_neg = -(lr / bc1)
    out = {}
    for n, g in grads.items():
        m = (1 - B1) * g
        v = (1 - B2) * g * g
        denom = (v.sqrt() / (bc2.sqrt() * step_size_neg)).add_(
            EPS / step_size_neg)
        out[n] = state[n].clone().addcdiv_(m, denom)
    return out


def relu_signs(state, bx):
    x, out = torch.as_tensor(bx), []
    for i in range(len(smoke.FRAUD["widths"])):
        z = (x @ state[f"layers_{i}.Dense_0.weight"].T
             + state[f"layers_{i}.Dense_0.bias"])
        out.append(z > 0)
        x = torch.relu(z)
    return out


def main():
    torch.manual_seed(0)
    state = {k: v.clone() for k, v in
             smoke._fraud_net().to_module().state_dict().items()}
    (x0, y0), (x1, y1) = smoke._fraud_batches(2, smoke.FRAUD["batch"],
                                              seed=11)
    _, g0 = loss_and_grads(state, x0, y0)
    dbl = first_update_double(state, g0)
    f32 = first_update_float32(state, g0)
    l_dbl, g_dbl = loss_and_grads(dbl, x1, y1)
    l_f32, g_f32 = loss_and_grads(f32, x1, y1)
    per_param = {n: smoke._rel_err(g_f32[n], g_dbl[n]) for n in g_dbl}
    flips = [int((a != b).sum()) for a, b in
             zip(relu_signs(dbl, x1), relu_signs(f32, x1))]
    print(json.dumps({
        "first_update_max_diff_over_lr": max(
            float((dbl[n] - f32[n]).abs().max()) for n in dbl) / LR,
        "second_step_loss_rel": abs(l_f32 - l_dbl) / abs(l_dbl),
        "second_step_grad_rel": max(per_param.values()),
        "grad_rel_by_param": per_param,
        "grad_max_by_param": {n: float(g.abs().max())
                              for n, g in g_dbl.items()},
        "relu_flips_by_layer": flips,
        "relus_by_layer": [len(x1) * w for w in smoke.FRAUD["widths"]]}))


if __name__ == "__main__":
    main()
