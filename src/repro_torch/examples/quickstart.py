"""Quickstart: the paper in a minute, on the card.

1. Build a small MLA model and prefill a canonical chunk into latent c^KV.
2. Partition the cache across simulated instances.
3. Route a decode query: partial attention per holder (the mla_decode
   kernel) + online-softmax merge (softmax_merge) == single-instance
   attention (the §3.3 exactness).
4. Ask the closed-form predicate which primitive a scheduler should use.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from typing import Dict

import torch

from repro_torch.core import constants as C
from repro_torch.core import predicate as P
from repro_torch.core.routing import route_simulated
from repro_torch.examples import device_of, parser
from repro_torch.kernels.mla_decode import mla_decode
from repro_torch.models import mla as M

CFG = M.MLAConfig(d_model=256, n_heads=8, kv_lora_rank=64,
                  qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32)
S = 256          # canonical chunk tokens
SHARDS = 4       # simulated holders, S // SHARDS rows each
# (m_q, expected reuse steps) of the three predicate rows
DECISIONS = ((256, 1), (256, 10_000), (1, 1))


def inputs(device) -> tuple:
    """The MLA parameters (seed 0) and the chunk's hidden states x (1, S,
    d_model) (seed 1), drawn on `device`."""
    gen = lambda seed: torch.Generator(device=device).manual_seed(seed)
    params = M.MLA(CFG, dtype=torch.float32, device=device,
                   generator=gen(0))
    x = 0.1 * torch.randn((1, S, CFG.d_model), generator=gen(1),
                          device=device)
    return params, x


def attend(params: M.MLA, x: torch.Tensor) -> Dict[str, object]:
    """Steps 1-3 on the arrays: the canonical c^KV (S, d_qk), the absorbed
    query row (1, H, d_qk) of the chunk's last token, the single-instance
    partial (plain version), the SHARDS-holder routed merge and the
    mla_decode wrapper's partial over the whole chunk."""
    pos = torch.arange(S, device=x.device)[None]
    ckv = M.latent_cache_entries(params, CFG, x, pos)[0]
    qn, qr = M.project_q(params, CFG, x[:, -1:], pos[:, -1:] + 1)
    q_abs = M.absorb_query(params, CFG, qn, qr)[:, 0]
    full = M.absorbed_partial_ref(CFG, q_abs, ckv)
    rows = S // SHARDS
    merged = route_simulated(CFG, q_abs, [ckv[i * rows:(i + 1) * rows]
                                          for i in range(SHARDS)])
    kernel = mla_decode(q_abs.contiguous(), ckv[None],
                        d_v=CFG.kv_lora_rank, scale=CFG.scale)
    return {"ckv": ckv, "q_abs": q_abs, "full": full, "merged": merged,
            "kernel": kernel}


def decisions() -> list:
    """Step 4: P.decide at c_t = 2048 on the H100 IBGDA fabric."""
    return [P.decide(P.Request(m_q=m_q, c_t=2048,
                               fabric=C.fabric("h100_ibgda"),
                               expected_reuse_steps=reuse))
            for m_q, reuse in DECISIONS]


def run(device="cuda") -> dict:
    params, x = inputs(torch.device(device))
    a = attend(params, x)
    ckv, q_abs, full = a["ckv"], a["q_abs"], a["full"]
    print(f"canonical c^KV: {tuple(ckv.shape)} ({ckv.numel() * 2} bytes "
          f"bf16/entry-row = the 'cache' side of the byte asymmetry)")
    print(f"absorbed query row: {q_abs.shape[-1]} wide "
          f"(DeepSeek-V2 geometry would be 576 = 1152 B)")
    err = float(torch.max(torch.abs(a["merged"].o - full.o)))
    print(f"{SHARDS}-holder route+merge vs single-instance: max|err| = "
          f"{err:.2e}")
    err_k = float(torch.max(torch.abs(a["kernel"].o[0] - full.o)))
    print(f"mla_decode kernel ({'CUDA' if x.is_cuda else 'plain version'}) "
          f"vs oracle:     max|err| = {err_k:.2e}")
    rows = []
    for (m_q, reuse), d in zip(DECISIONS, decisions()):
        print(f"M_q={m_q:>4} reuse={reuse:>6}: {d.primitive.value:<6} "
              f"(route {d.t_route*1e6:7.1f}us | fetch {d.t_fetch*1e6:9.1f}us "
              f"| local {d.t_local*1e6:9.1f}us) — {d.reason}")
        rows.append({"m_q": m_q, "reuse": reuse,
                     "primitive": d.primitive.value, "t_route": d.t_route,
                     "t_fetch": d.t_fetch, "t_local": d.t_local})
    return {"ckv_shape": tuple(ckv.shape), "q_width": q_abs.shape[-1],
            "route_err": err, "kernel_err": err_k, "decisions": rows}


def main(argv=None) -> dict:
    args = parser("quickstart").parse_args(argv)
    return run(device_of("quickstart", args.device))


if __name__ == "__main__":
    main()
