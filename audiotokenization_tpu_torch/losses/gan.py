"""LSGAN losses and feature matching (counterpart of
``audiotokenization_tpu/losses/gan.py``): the discriminator gets
mse(real, 1) + mse(fake, 0), the generator mse(fake, 1), on the last entry
(the logits) of every sub-discriminator's feature list; feature matching is
the L1 over every other entry, the real side detached, summed. Every loss
accumulates in fp32 whatever the feature dtype.
"""
from __future__ import annotations

from typing import Sequence

import torch

Features = Sequence[Sequence[torch.Tensor]]


def _mse(x, target: float):
    return torch.mean(torch.square(x.float() - target))


def disc_loss(real_outs: Features, fake_outs: Features):
    """(Σ mse(real logits, 1), Σ mse(fake logits, 0)) over sub-discriminators."""
    real_loss = sum(_mse(r[-1], 1.0) for r in real_outs)
    fake_loss = sum(_mse(f[-1], 0.0) for f in fake_outs)
    return real_loss, fake_loss


def gen_adv_loss(fake_outs: Features):
    return sum(_mse(f[-1], 1.0) for f in fake_outs)


def feature_matching_loss(fake_outs: Features, real_outs: Features):
    loss = 0.0
    for f_list, r_list in zip(fake_outs, real_outs):
        for f, r in zip(f_list[:-1], r_list[:-1]):
            loss = loss + torch.mean(torch.abs(f.float() - r.detach().float()))
    return loss
