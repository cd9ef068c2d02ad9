"""Knowledge-distillation losses (LwF / EBLL / iCaRL).

Counterpart of ``clsurvey_tpu/ops/distill.py``; plain tensor functions.
``lwf_distill`` reproduces the reference's distillation cross-entropy
exactly (ref:src/methods/LwF/main_LWF.py:47-75): both student and teacher
logits are max-normalized, the teacher target is softmax(t/T) (the code's
softmax(t)^(1/T) renormalized — the same distribution), the student term is
``logsumexp(y/T) - sum(p_t * y/T)``, averaged over the batch. No T^2
scaling (gradients match the reference's)."""

from __future__ import annotations

import torch


def lwf_distill(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                T: float = 2.0) -> torch.Tensor:
    """(..., B, C) x (..., B, C) -> (...) : the batch mean per leading
    index; a scalar for plain (B, C) inputs."""
    ysafe = (student_logits
             - student_logits.max(dim=-1, keepdim=True).values) / T
    t = teacher_logits - teacher_logits.max(dim=-1, keepdim=True).values
    p_t = torch.softmax(t / T, dim=-1)
    loss = torch.logsumexp(ysafe, dim=-1) - (p_t * ysafe).sum(dim=-1)
    return loss.mean(dim=-1)


def lwf_distill_multi(student_all: torch.Tensor, teacher_all: torch.Tensor,
                      T: float = 2.0) -> torch.Tensor:
    """All previous heads at once: (B, n_prev, C) pairs -> summed scalar
    (the reference sums per-head distillation losses,
    ref:src/methods/LwF/main_LWF.py:190-194)."""
    return lwf_distill(student_all.transpose(0, 1),
                       teacher_all.transpose(0, 1), T).sum()


def icarl_distill(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                  T: float = 2.0) -> torch.Tensor:
    """iCaRL's exemplar distillation with torch
    ``KLDivLoss(reduction='batchmean')`` semantics: pointwise
    ``KL(softmax(t/T) || softmax(s/T))`` SUMMED over classes, MEANED over
    the batch, scaled by T^2 (ref:src/methods/rehearsal/model/icarl.py:64
    builds the loss, :578-582 applies it to T-softened log/softmax pairs).

    Accepts NEG_INF-masked logits (rows restricted to one task's class
    region): masked entries produce p_t = 0 and contribute nothing."""
    log_p_s = torch.log_softmax(student_logits / T, dim=1)
    p_t = torch.softmax(teacher_logits / T, dim=1)
    kl_el = torch.where(
        p_t > 0, p_t * (torch.log(p_t.clamp(min=1e-30)) - log_p_s), 0.0)
    return kl_el.sum(dim=1).mean() * (T ** 2)
