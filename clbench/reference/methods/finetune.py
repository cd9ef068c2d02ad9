"""Finetuning: the cross-entropy alone."""


def extra_loss(p, params, feats, x, teacher):
    return 0.0
