"""Sampling semantics — the port's copy of ``shifu_tpu.train.sampling``
(reference ``AbstractNNWorker.java:668-716,737-757``): the validation
split, k-fold assignment, bagging weights and the ``[members, rows]``
train/validation weight matrices of an ensemble, as seeded numpy masks.
The same numpy generators run in the same order, so both packages draw
the same rows from the same seeds.  ``upSampleWeight`` (set by the NN
trainers) multiplies the positive rows' training weights.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def validation_split(n: int, valid_rate: float, seed: int = 0,
                     stratified: bool = False,
                     targets: Optional[np.ndarray] = None) -> np.ndarray:
    """Boolean mask, True = validation row.  Stratified keeps the pos/neg
    ratio in both splits (reference stratified sampling path)."""
    rng = np.random.default_rng(seed)
    if not stratified or targets is None:
        return rng.random(n) < valid_rate
    mask = np.zeros(n, dtype=bool)
    for cls in np.unique(targets):
        idx = np.flatnonzero(targets == cls)
        k = int(round(len(idx) * valid_rate))
        mask[rng.choice(idx, size=k, replace=False)] = True
    return mask


def kfold_assignment(n: int, k: int, seed: int = 0) -> np.ndarray:
    """Fold id per row (reference k-fold crossValidation: fold i is member
    i's validation shard)."""
    rng = np.random.default_rng(seed)
    return rng.permutation(np.arange(n) % k)


def bagging_weights(n: int, bags: int, sample_rate: float = 1.0,
                    replacement: bool = False, seed: int = 0,
                    up_sample_weight: float = 1.0,
                    targets: Optional[np.ndarray] = None) -> np.ndarray:
    """[bags, n] per-row sample weights.

    with replacement → Poisson(rate) counts (the classic bootstrap
    approximation the reference's per-record re-draw converges to) — even for
    baggingNum=1, matching the reference's per-job sampling; without
    replacement → Bernoulli(rate) 0/1 mask, except a single bag at full rate
    sees every row.  ``upSampleWeight`` multiplies positive rows (reference
    up-sampling)."""
    rng = np.random.default_rng(seed)
    if bags == 1 and sample_rate >= 1.0 and not replacement:
        w = np.ones((1, n), np.float32)
    elif replacement:
        w = rng.poisson(sample_rate, size=(bags, n)).astype(np.float32)
    else:
        w = (rng.random((bags, n)) < sample_rate).astype(np.float32)
    if up_sample_weight != 1.0 and targets is not None:
        w = w * np.where(targets > 0.5, up_sample_weight,
                         1.0)[None, :].astype(np.float32)
    return w


def member_masks(n: int, bags: int, *, valid_rate: float, kfold: int = -1,
                 sample_rate: float = 1.0, replacement: bool = False,
                 stratified: bool = False, up_sample_weight: float = 1.0,
                 targets: Optional[np.ndarray] = None,
                 seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(train_w, valid_w): [bags, n] float32 row-weight matrices for every
    ensemble member.  k-fold mode makes ``bags == kfold`` members whose
    validation shards partition the data; otherwise one shared validation
    split + per-bag bagging weights."""
    if kfold and kfold > 1:
        fold = kfold_assignment(n, kfold, seed)
        valid_w = np.stack([(fold == i).astype(np.float32) for i in range(kfold)])
        train_w = 1.0 - valid_w
        if up_sample_weight != 1.0 and targets is not None:
            train_w = train_w * np.where(targets > 0.5, up_sample_weight,
                                         1.0)[None, :]
        return train_w.astype(np.float32), valid_w
    vmask = validation_split(n, valid_rate, seed, stratified, targets)
    bag_w = bagging_weights(n, bags, sample_rate, replacement, seed + 1,
                            up_sample_weight, targets)
    train_w = bag_w * (~vmask)[None, :]
    valid_w = np.broadcast_to(vmask.astype(np.float32), (bags, n)).copy()
    return train_w.astype(np.float32), valid_w.astype(np.float32)
