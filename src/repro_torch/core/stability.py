"""Probes of the paper's Definition 4.1 ((N, r)-federated-stabilized
adapters): forward output moments and backward input-gradient magnitudes
of the scaled adapter gamma B A, and the activation moments of App. B.4.

The port of ``repro/core/stability.py``.  Each probe draws its random
inputs from a ``torch.Generator``, or takes them as given (a tensor in
place of the generator), so that tests can pass the JAX package's
``jax.random`` draws across.
"""
from __future__ import annotations

import torch

from repro_torch.core.scaling import scaling_factor


def _probe(probe, shape, device):
    """``probe`` itself when it is a tensor (checked against ``shape``),
    else a standard normal draw of ``shape`` from the generator."""
    if isinstance(probe, torch.Tensor):
        if tuple(probe.shape) != tuple(shape):
            raise ValueError(f"probe has shape {tuple(probe.shape)}, the "
                             f"adapter needs {tuple(shape)}")
        return probe.to(device=device, dtype=torch.float32)
    return torch.randn(shape, generator=probe, device=device,
                       dtype=torch.float32)


def adapter_forward_moment(a, b, gamma, probe, h: int = 2,
                           n_probe: int = 64):
    """E[|gamma B A x|^h] per entry for x ~ N(0, I): a (r, d_in), b
    (d_out, r); ``probe`` a generator or the (n_probe, d_in) inputs."""
    x = _probe(probe, (n_probe, a.shape[-1]), a.device)
    y = gamma * (x @ a.float().T) @ b.float().T
    return torch.mean(torch.abs(y) ** h)


def adapter_backward_moment(a, b, gamma, probe, n_probe: int = 64):
    """RMS of dL/dx for dL/dy ~ N(0, I), the backward stability probe;
    ``probe`` a generator or the (n_probe, d_out) cotangents."""
    v = _probe(probe, (n_probe, b.shape[-2]), a.device)
    gx = gamma * (v @ b.float()) @ a.float()
    return torch.sqrt(torch.mean(torch.square(gx)))


def aggregated_moment_sweep(generator: torch.Generator, *, d: int = 512,
                            ranks=(4, 32, 128, 512), clients=(1, 4, 16),
                            scaling_fns=None, sigma: float = 0.02,
                            eta: float = 0.1):
    """One FedSA step simulated analytically (paper App. A, n = 1): B_i^(1)
    = -eta gamma v x^T A_i^(0)T, A^(1) = A_bar; the RMS of gamma B^(1)
    A_bar x on the training input, for each scaling over (N, r).

    Returns {scaling: {(N, r): moment}}; theory says sfedlora's is about
    constant.  Every scaling sees the same draws: for each (N, r), in
    ``clients`` then ``ranks`` order, the N clients' A, then x, then v."""
    draws = {}
    for n in clients:
        for r in ranks:
            a_i = [sigma * torch.randn((r, d), generator=generator,
                                       device=generator.device)
                   for _ in range(n)]
            x = torch.randn((d,), generator=generator, device=generator.device)
            v = torch.randn((d,), generator=generator, device=generator.device)
            draws[(n, r)] = (a_i, x, v)
    out = {}
    for name in (scaling_fns or ("lora", "rslora", "sfedlora")):
        res = {}
        for (n, r), (a_i, x, v) in draws.items():
            g = scaling_factor(name, 8.0, r, n)
            a_bar = sum(a_i) / n
            # B^(1) = -eta g v (x^T A0^T); evaluated on the training input
            # itself (the paper's eq. 21 assumes test and train inputs with
            # Theta(1) correlation; the r/N factor comes from E[A0^T A_bar])
            b1 = -eta * g * torch.outer(v, a_i[0] @ x)
            y = g * b1 @ (a_bar @ x)
            res[(n, r)] = float(torch.sqrt(torch.mean(torch.square(y))))
        out[name] = res
    return out


@torch.no_grad()
def activation_moments(model, params, batch, adapters):
    """Mean and variance of the final logits over the padded vocabulary
    (the paper's Fig. 9 proxy, as JAX takes it); ``adapters`` an
    AdapterSet."""
    logits, _ = model.forward(params, batch, adapters=adapters)
    return {"mean": float(torch.mean(logits)),
            "var": float(torch.var(logits, unbiased=False))}
