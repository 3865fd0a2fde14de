#!/usr/bin/env python3
"""CPU emulation of how K4's tensor-core route feeds P to the PV product.

    PYTHONPATH=src python scripts/k4_bf16_p_emulation.py

At the shape ``chip_smoke.py`` times K4 at (B=1, S=2048, 24/8 heads, D=128,
causal; N(0, 1) inputs rounded to bf16, from a seed) it runs the flash
recurrence on 128 x 128 tiles in f32 torch on the CPU, with the
probabilities P entering PV (a) in f32, (b) rounded once to bf16, as a
single bf16 ``wgmma`` would take them, and (c) as a bf16 hi + lo pair with
two products, as ``csrc/flash_attention_tc.cu`` does. Each bf16 output is
compared with ``flash_attention_plain`` under ``chip_smoke.py``'s bf16
bound (1e-3 + 8e-3 |plain|). QK^T needs no emulation: a bf16 x bf16
product is exact in f32. This is a CPU emulation of the numerics, not a
measurement of the card.
"""
import sys

import numpy as np
import torch

from repro_torch.kernels.flash_attention import flash_attention_plain

B, S, HQ, HKV, D, TILE = 1, 2048, 24, 8, 128, 128
ATOL, RTOL = 1e-3, 8e-3


def emulate(q, k, v, p_mode):
    """The tiled recurrence in f32 with P fed to PV as ``p_mode``."""
    G = HQ // HKV
    qt = q.permute(0, 2, 1, 3).float()
    kt = k.permute(0, 2, 1, 3).float().repeat_interleave(G, dim=1)
    vt = v.permute(0, 2, 1, 3).float().repeat_interleave(G, dim=1)
    out = torch.empty_like(qt)
    pos = torch.arange(S)
    for q0 in range(0, S, TILE):
        qb = qt[:, :, q0:q0 + TILE]
        m = torch.full(qb.shape[:-1] + (1,), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qb)
        for k0 in range(0, q0 + TILE, TILE):
            s = qb @ kt[:, :, k0:k0 + TILE].transpose(-1, -2) * D ** -0.5
            mask = pos[q0:q0 + TILE, None] >= pos[None, k0:k0 + TILE]
            s = torch.where(mask, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.where(mask, torch.exp(s - m_new), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            vb = vt[:, :, k0:k0 + TILE]
            if p_mode == "f32":
                pv = p @ vb
            else:
                hi = p.bfloat16().float()
                pv = hi @ vb
                if p_mode == "bf16 hi + lo":
                    pv = pv + (p - hi).bfloat16().float() @ vb
            acc = acc * alpha + pv
            m = m_new
        out[:, :, q0:q0 + TILE] = acc / l.clamp(min=1e-30)
    return out.permute(0, 2, 1, 3).bfloat16()


def main() -> int:
    torch.set_num_threads(4)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, h, D))
                                .astype(np.float32)).bfloat16()
               for h in (HQ, HKV, HKV))
    want = flash_attention_plain(q, k, v, causal=True).float()
    print(f"B={B} S={S} heads={HQ}/{HKV} D={D} causal, {want.numel()} "
          f"outputs; bound {ATOL} + {RTOL} |plain| (CPU emulation)")
    for mode in ("f32", "bf16 once", "bf16 hi + lo"):
        got = emulate(q, k, v, mode).float()
        diff = (got - want).abs()
        excess = diff - (ATOL + RTOL * want.abs())
        print(f"P {mode:>12}: {int((excess > 0).sum())} outputs beyond the "
              f"bound, worst excess {float(excess.max()):.3g}, max abs error "
              f"{float(diff.max()):.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
