"""Method registry (ref:src/methods/method.py:35-78 ``parse``).

This slice ports the two baselines on the main path, ``finetuning`` and
``joint``; any other name raises."""

from __future__ import annotations

from clsurvey_torch.methods.base import Category, Method, UpdateRule  # noqa: F401


def parse(method_name: str) -> Method:
    """String -> Method object."""
    from clsurvey_torch.methods.finetune import Finetune, Joint

    exact = {Finetune().name: Finetune, Joint().name: Joint}
    if method_name in exact:
        return exact[method_name]()
    raise NotImplementedError(
        f"method {method_name} is not ported to clsurvey_torch (ROADMAP.md, "
        f"queue 1: the methods); use clsurvey_tpu for it")
