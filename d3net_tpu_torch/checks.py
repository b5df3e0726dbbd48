"""The speaker on cuda against the speaker on cpu, shared by
``chip_smoke.py`` (phase ``caption_parity``) and the card test
``tests/test_torch_cuda.py::test_speaker_cuda_matches_cpu``.

The greedy decode is a chain of argmaxes: where f32 sums reorder on the
card, a near-tie can flip a token and the rest of its row with it. So the
ids must be equal, and each device's logits are compared teacher-forced on
the cpu's ids (``teacher_forced_logits``), which keeps one flip from
hiding or causing every later difference. For a row whose ids differ the
report gives the cpu's top-2 margin at the first difference.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from d3net_tpu_torch import device
from d3net_tpu_torch.params import load_pipeline

SPEAKER_INTS = ("adjacent_mat", "local_ids", "local_mask")
SPEAKER_FLOATS = ("bbox_feature", "edge_feature", "edge_orientations")


def teacher_forced_logits(caption, embeddings, target_feat, obj_feats,
                          valid_masks, ids: torch.Tensor) -> torch.Tensor:
    """``greedy_decode``'s rollout with step t reading ``ids[:, t-1]`` (sos
    at t = 0) in place of its own previous pick -> logits (N, T, V)."""
    n = target_feat.shape[0]
    feat_proj = caption.map_feat(obj_feats)
    h = target_feat.new_zeros(n, caption.hidden_size)
    hiddens = (h, h)
    words = torch.cat([ids.new_full((n, 1), caption.sos_id), ids[:, :-1]],
                      1).long()
    out = []
    for t in range(ids.shape[1]):
        logits, hiddens, _ = caption.step(hiddens, embeddings[words[:, t]],
                                          target_feat, obj_feats, valid_masks,
                                          feat_proj)
        out.append(logits)
    return torch.stack(out, 1)


def speaker_cuda_vs_cpu(variables, cfg, vocab, data: Dict[str, np.ndarray],
                        rtol: float = 1e-4, atol: float = 1e-5
                        ) -> Dict[str, Any]:
    """The pipeline's speaker of ``variables`` in eval mode on ``data``
    (proposals and ``glove_embeddings``, numpy) on cpu and on cuda, inside
    ``device.parity_precision()``. The cuda decode runs once more under
    CUDA's sync debug mode "error", so a host sync in its loop raises.
    ``ok`` is true when the graph's integers and the ids are equal and
    every float output is within ``rtol``/``atol``."""
    outs, logits = {}, {}
    with device.parity_precision(), torch.no_grad():
        for dev in ("cpu", "cuda"):
            spk = load_pipeline(variables, cfg, vocab, device=dev).speaker
            out = spk({k: torch.from_numpy(v).to(dev) for k, v in data.items()},
                      mode="eval")
            inputs = spk.caption.eval_inputs(out)
            emb = out["glove_embeddings"]
            if dev == "cpu":
                cpu_ids = out["lang_cap"].flatten(0, 1)
            else:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    spk.caption.greedy_decode(emb, *inputs)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            logits[dev] = teacher_forced_logits(spk.caption, emb, *inputs,
                                                cpu_ids.to(dev)).cpu()
            outs[dev] = {k: v.cpu() for k, v in out.items()}
    cpu, gpu = outs["cpu"], outs["cuda"]
    ints = {k: bool(torch.equal(cpu[k], gpu[k])) for k in SPEAKER_INTS}
    pairs = {k: (gpu[k], cpu[k]) for k in SPEAKER_FLOATS}
    pairs["teacher_forced_logits"] = (logits["cuda"], logits["cpu"])
    errs = {k: float((g - c).abs().max()) for k, (g, c) in pairs.items()}
    bad = [k for k, (g, c) in pairs.items()
           if not torch.allclose(g, c, rtol=rtol, atol=atol)]
    ids_c, ids_g = cpu["lang_cap"].flatten(0, 1), gpu["lang_cap"].flatten(0, 1)
    rows = (ids_c != ids_g).any(1).nonzero()[:, 0].tolist()
    margins = []
    for r in rows[:10]:
        t = int((ids_c[r] != ids_g[r]).nonzero()[0, 0])
        top2 = logits["cpu"][r, t].topk(2).values
        margins.append({"row": r, "step": t,
                        "cpu_top2_margin": float(top2[0] - top2[1])})
    return {"ok": all(ints.values()) and not bad and not rows,
            "rows": int(ids_c.shape[0]), "steps": int(ids_c.shape[1]),
            "integers_equal": ints, "max_abs_err": errs,
            "outside_tolerance": bad, "ids_equal": not rows,
            "rows_differing": len(rows), "first_difference": margins,
            "distinct_words": int(torch.unique(ids_c).numel()),
            "rtol": rtol, "atol": atol}
