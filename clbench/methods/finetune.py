"""Finetuning: the program's base rule, plain SGD with momentum."""

TEACHER = False
EXTRA_FORWARDS = 0


def program_rule():
    from clsurvey_torch.methods.base import UpdateRule

    return UpdateRule()


def program_state(rule, ctx, hyper: dict, teacher):
    return rule.init_state(None, dict(hyper), ctx)
