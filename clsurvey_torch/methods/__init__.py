"""Method registry (ref:src/methods/method.py:35-78 ``parse``).

Ported so far: the baselines ``finetuning``, ``joint`` and the two replay
baselines ``finetuning_rehearsal_partial_mem`` / ``_full_mem``, the
importance regularisers ``EWC``, ``MAS`` and ``SI``, the distillation
methods ``LWF`` and ``EBLL``, IMM, whose mode is parsed from the name
(``mean_IMM`` / ``mode_IMM``), the rehearsal methods ``GEM`` and ``ICARL``,
and ``packnet``. Any other name of the JAX package raises, naming its
ROADMAP item."""

from __future__ import annotations

from clsurvey_torch.methods.base import Category, Method, UpdateRule  # noqa: F401

# method name of the JAX package -> its item in ROADMAP.md, queue 1
_NOT_PORTED = {"HAT": "item 9: HAT", "pathnet": "item 10: PathNet"}


def parse(method_name: str) -> Method:
    """String -> Method object."""
    from clsurvey_torch.methods.ebll import EBLL
    from clsurvey_torch.methods.finetune import Finetune, Joint
    from clsurvey_torch.methods.lwf import LWF
    from clsurvey_torch.methods.packnet import PackNet
    from clsurvey_torch.methods.reg_based import EWC, MAS, SI
    from clsurvey_torch.methods.rehearsal import (
        GEM, ICARL, FinetuneRehearsalFullMem, FinetuneRehearsalPartialMem)

    exact = {cls().name: cls for cls in (
        Finetune, Joint, EWC, MAS, SI, LWF, EBLL, GEM, ICARL, PackNet,
        FinetuneRehearsalPartialMem, FinetuneRehearsalFullMem)}
    if method_name in exact:
        return exact[method_name]()
    item = _NOT_PORTED.get(method_name)
    if item is None and "IMM" in method_name:
        from clsurvey_torch.methods.imm import IMM
        mode = method_name.replace("_", "").replace("IMM", "").strip()
        return IMM(mode=mode or "mean")
    if item is None:
        raise NotImplementedError(f"Method not yet parseable: {method_name}")
    raise NotImplementedError(
        f"method {method_name} is not ported to clsurvey_torch yet "
        f"(ROADMAP.md, queue 1, {item}); use clsurvey_tpu for it")
