"""Method registry (ref:src/methods/method.py:35-78 ``parse``).

Every name the JAX package's ``parse`` knows is ported: the baselines
``finetuning``, ``joint`` and the two replay baselines
``finetuning_rehearsal_partial_mem`` / ``_full_mem``, the importance
regularisers ``EWC``, ``MAS`` and ``SI``, the distillation methods ``LWF``
and ``EBLL``, IMM, whose mode is parsed from the name (``mean_IMM`` /
``mode_IMM``), the rehearsal methods ``GEM`` and ``ICARL``, and the mask
methods ``packnet``, ``HAT`` and ``pathnet``, on the VGG family and on
AlexNet."""

from __future__ import annotations

from clsurvey_torch.methods.base import Category, Method, UpdateRule  # noqa: F401


def parse(method_name: str) -> Method:
    """String -> Method object."""
    from clsurvey_torch.methods.ebll import EBLL
    from clsurvey_torch.methods.finetune import Finetune, Joint
    from clsurvey_torch.methods.hat import HAT
    from clsurvey_torch.methods.lwf import LWF
    from clsurvey_torch.methods.packnet import PackNet
    from clsurvey_torch.methods.pathnet import PathNet
    from clsurvey_torch.methods.reg_based import EWC, MAS, SI
    from clsurvey_torch.methods.rehearsal import (
        GEM, ICARL, FinetuneRehearsalFullMem, FinetuneRehearsalPartialMem)

    exact = {cls().name: cls for cls in (
        Finetune, Joint, EWC, MAS, SI, LWF, EBLL, GEM, ICARL, PackNet, HAT,
        PathNet, FinetuneRehearsalPartialMem, FinetuneRehearsalFullMem)}
    if method_name in exact:
        return exact[method_name]()
    if "IMM" in method_name:
        from clsurvey_torch.methods.imm import IMM
        mode = method_name.replace("_", "").replace("IMM", "").strip()
        return IMM(mode=mode or "mean")
    raise NotImplementedError(f"Method not yet parseable: {method_name}")
