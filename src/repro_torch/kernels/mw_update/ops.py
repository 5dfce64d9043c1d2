"""Public wrapper of the fused MW update: route by the tensors' device.

A CPU tensor (or ``interpret=True`` on any device) goes to the plain
version in ``ref.py``; a CUDA tensor goes to the hand-written kernel
and nowhere else — a failed build or launch raises.  ``launches``
counts kernel launches (the plain version never adds to it), so a run
can show that its main path went through the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.mw_update import ref

launches = 0


def mw_update(hits: torch.Tensor, correct: torch.Tensor,
              alive: torch.Tensor, shift: torch.Tensor | None = None, *,
              interpret: bool | None = None):
    """Fused step 2(f) + 2(b): ``new_hits = hits + 1[correct ∧ alive]``
    and ``wsum = Σ_alive 2^(shift − new_hits)`` per row.

    hits int32 [R, m]; correct, alive bool [R, m]; shift int32 [R] (0
    if None), at most each row's least alive hit count so the terms
    stay normal floats; all on one device and contiguous.  Returns
    (new_hits int32 [R, m], wsum float32 [R]); new_hits is a fresh
    tensor.  The ragged edge (m not a multiple of the kernel's block)
    is masked inside both versions, which sum in one order (``ref.py``).
    """
    global launches
    if hits.dtype != torch.int32 or correct.dtype != torch.bool \
            or alive.dtype != torch.bool:
        raise TypeError("mw_update takes int32 hits and bool "
                        "correct/alive")
    if hits.ndim != 2 or correct.shape != hits.shape \
            or alive.shape != hits.shape:
        raise ValueError(f"mw_update shapes differ or are not [R, m]: "
                         f"{hits.shape}, {correct.shape}, {alive.shape}")
    if shift is None:
        shift = torch.zeros(hits.shape[:1], dtype=torch.int32,
                            device=hits.device)
    if shift.dtype != torch.int32 or shift.shape != hits.shape[:1]:
        raise ValueError(f"mw_update takes an int32 shift [R], got "
                         f"{shift.dtype} {tuple(shift.shape)}")
    if not (correct.device == alive.device == shift.device == hits.device):
        raise ValueError("mw_update inputs lie on different devices")
    if interpret or hits.device.type == "cpu":
        if interpret is False:
            raise ValueError("the mw_update kernel needs CUDA tensors")
        return ref.mw_update_ref(hits, correct, alive, shift)
    if not (hits.is_contiguous() and correct.is_contiguous()
            and alive.is_contiguous()):
        raise ValueError("mw_update takes contiguous tensors")
    R, m = hits.shape
    if not 0 < R <= 65535 or m == 0:
        raise ValueError(f"mw_update needs 1..65535 non-empty rows, "
                         f"got [{R}, {m}]")
    from repro_torch.kernels.mw_update import kernel

    new_hits = torch.empty_like(hits)
    wsum = torch.empty((R,), dtype=torch.float32, device=hits.device)
    kernel.launch(hits, correct, alive, shift.contiguous(), new_hits, wsum,
                  torch.cuda.current_stream(hits.device))
    launches += 1
    return new_hits, wsum
