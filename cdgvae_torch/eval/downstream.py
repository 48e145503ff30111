"""Downstream evaluations: sample efficiency and distributional robustness
(port of ``cdgvae_tpu/eval/downstream.py:23-193``).

A downstream classifier (node -> 2 -> 1, sigmoid) is fit on posterior
means with the reference's semantics: Adam at lr 0.005 on the clipped
BCE, a fresh permutation of the rows every epoch, ``max(n // bs, 1)``
steps of ``min(batch_size, n)`` rows, the remainder dropped. The JAX
package runs each fit as one ``lax.scan``; here the ``repeats`` of an eval
are independent fits stacked on a leading axis (``DownstreamClassifier``
with ``members``) and trained as one: the loss is the sum of the members'
mean losses, so each member gets its own gradient, and Adam's update is
elementwise, so each member takes the step its own fit would. A fit draws
its permutations on the device and never waits for it. On CUDA the steps
of an epoch are one CUDA graph, captured once a fit and replayed every
epoch on that epoch's batches (the eager steps spend over a millisecond
each in host launches, for some 30 small kernels); on the CPU they run
eagerly.

"""
from __future__ import annotations

import gc

import numpy as np
import torch

from ..data.pendulum import _BETA
from ..models.classifier import DownstreamClassifier
from ..ops.losses import clipped_bce_probs
from ..train.scanned import capture_stream
from ..train.steps import make_optimizer
from ..utils.simulation import DOWNSTREAM, derived_generator, derived_seed


@torch.no_grad()
def extract_representations(model, x_data: torch.Tensor,
                            batch_size: int = 512) -> torch.Tensor:
    """Posterior means of the whole dataset, [n, node] on its device."""
    return torch.cat([model.get_posterior(x_data[i: i + batch_size])[0]
                      for i in range(0, len(x_data), batch_size)])


def synthetic_targets(labels: np.ndarray, rng: np.random.Generator):
    """Bernoulli targets from the label logit: sigmoid(logit + 2 sin(logit)),
    the sign as the reference writes it (the DGP has -2 sin)."""
    logit = labels[:, :4] @ _BETA
    p = 1.0 / (1.0 + np.exp(-logit - 2.0 * np.sin(logit)))
    return rng.binomial(1, p).astype(np.float32)[:, None]


def train_downstream(reps: torch.Tensor, targets: torch.Tensor, seed: int,
                     epochs: int = 100, batch_size: int = 32,
                     lr: float = 0.005, *,
                     init: DownstreamClassifier | None = None,
                     perms: torch.Tensor | None = None
                     ) -> DownstreamClassifier:
    """Fit one downstream classifier per member: ``reps`` [members, n, d]
    and ``targets`` [members, n, 1] on one device. The init is drawn from
    a generator derived from ``seed`` (or ``init``, trained in place), each
    epoch's row orders from another on the device (or ``perms`` [epochs,
    members, n]). Returns the trained classifier."""
    members, n, d = reps.shape
    dev = reps.device
    steps, bs = max(n // batch_size, 1), min(batch_size, n)
    clf = init if init is not None else DownstreamClassifier(
        d, members, generator=derived_generator(seed, DOWNSTREAM, 0),
        device=dev)
    generator = derived_generator(seed, DOWNSTREAM, 1, device=dev)
    graphed = dev.type == "cuda"
    opt = make_optimizer(clf, lr, capturable=graphed)
    params = list(clf.parameters())
    rows = torch.arange(members, device=dev)[:, None, None]
    # the epoch's batches, [members, steps, bs, .]: the graph reads them
    # from these buffers
    xb = reps.new_empty((members, steps, bs, d))
    yb = targets.new_empty((members, steps, bs, 1))

    def step(s: int):
        loss = clipped_bce_probs(clf(xb[:, s]), yb[:, s]).mean(
            dim=(1, 2)).sum()
        for p, g in zip(params, torch.autograd.grad(loss, params)):
            p.grad = g
        opt.step()

    def run_epoch():
        for s in range(steps):
            step(s)

    graph = None
    for e in range(epochs):
        perm = (perms[e] if perms is not None else torch.rand(
            (members, n), generator=generator, device=dev).argsort(dim=1))
        idx = perm[:, : steps * bs].reshape(members, steps, bs)
        xb.copy_(reps[rows, idx])
        yb.copy_(targets[rows, idx])
        if graphed and graph is None:
            graph = _capture(run_epoch, step, clf, opt)
        if graph is not None:
            graph.replay()
        else:
            run_epoch()
    clf.zero_grad(set_to_none=True)  # the graph's buffers go with it
    return clf


def _capture(run_epoch, step, clf: DownstreamClassifier,
             opt: torch.optim.Adam) -> torch.cuda.CUDAGraph:
    """A CUDA graph of ``run_epoch``. One warm-up step on the port's
    capture stream (``train/scanned.py::capture_stream``) makes Adam's
    state and the autograd buffers; the params and the state are then put
    back as they were, and the capture itself runs nothing. Garbage is
    collected first, as ``CapturedStep`` does: a dead graph collected
    inside the capture would invalidate it."""
    saved = [p.detach().clone() for p in clf.parameters()]
    side = capture_stream(torch.cuda.current_device())
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(0)
    torch.cuda.current_stream().wait_stream(side)
    with torch.no_grad():
        for p, v in zip(clf.parameters(), saved):
            p.copy_(v)
        for state in opt.state.values():
            for t in state.values():
                t.zero_()
    gc.collect()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        run_epoch()
    return graph


@torch.no_grad()
def _predictions(clf: DownstreamClassifier, reps: torch.Tensor) -> np.ndarray:
    """[members, n, 1] bool: probability > 0.5."""
    return (clf(reps) > 0.5).cpu().numpy()


def accuracy(clf: DownstreamClassifier, reps: torch.Tensor,
             targets: np.ndarray) -> list[float]:
    """Each member's accuracy on ``reps`` [n, d] against ``targets``
    [n, 1]."""
    return [float((pred == targets).mean())
            for pred in _predictions(clf, reps)]


def worst_group_accuracy(clf: DownstreamClassifier, reps: torch.Tensor,
                         targets: np.ndarray, groups: np.ndarray
                         ) -> list[tuple[float, float]]:
    """Each member's (average, worst-group) accuracy; groups key the rows
    (background != target in the robustness eval)."""
    out = []
    for pred in _predictions(clf, reps):
        correct = (pred.astype(np.float32) == targets).astype(
            np.float32)[:, 0]
        out.append((float(correct.mean()),
                    min(float(correct[groups == g].mean())
                        for g in np.unique(groups))))
    return out


def sample_efficiency(model, train_x, train_y, test_x, test_y,
                      seed: int = 0, repeats: int = 10) -> dict:
    """acc(100 training rows) / acc(all rows), each the mean over
    ``repeats`` fits of 100 epochs (batch 32 and 64)."""
    rng = np.random.default_rng(seed)
    reps_train = extract_representations(model, train_x)
    reps_test = extract_representations(model, test_x)
    t_train = synthetic_targets(train_y, rng)
    t_test = synthetic_targets(test_y, rng)
    sel = torch.as_tensor(np.stack([
        rng.permutation(len(reps_train))[:100] for _ in range(repeats)]),
        device=reps_train.device)

    targets = torch.as_tensor(t_train, device=reps_train.device)
    clf = train_downstream(reps_train[sel], targets[sel],
                           derived_seed(seed, 0), epochs=100,
                           batch_size=32)
    a100 = float(np.mean(accuracy(clf, reps_test, t_test)))
    clf = train_downstream(reps_train.expand(repeats, -1, -1),
                           targets.expand(repeats, -1, -1),
                           derived_seed(seed, 1), epochs=100, batch_size=64)
    aall = float(np.mean(accuracy(clf, reps_test, t_test)))
    return {"accuracy_100": a100, "accuracy_all": aall,
            "sample_efficiency": a100 / aall}


def robustness(model, train_x, train_y, test_x, test_y, seed: int = 0,
               repeats: int = 10, epochs: int = 500,
               drop_last_latent: bool = True,
               return_detail: bool = False) -> dict:
    """The DR robustness eval: fit the downstream classifier on the latent
    means (the last, spurious latent dropped unless
    ``drop_last_latent=False``) against the target column, and report the
    average and the worst-group accuracy on the test split, groups keyed
    on background != target. Labels are [..., background, target]."""
    reps_train = extract_representations(model, train_x)
    reps_test = extract_representations(model, test_x)
    if drop_last_latent:
        keep = model.node - 1
        reps_train, reps_test = reps_train[:, :keep], reps_test[:, :keep]
    t_train = train_y[:, -1:].astype(np.float32)
    t_test = test_y[:, -1:].astype(np.float32)
    g_test = (test_y[:, -2] != test_y[:, -1]).astype(np.int32)

    targets = torch.as_tensor(t_train, device=reps_train.device)
    clf = train_downstream(reps_train.expand(repeats, -1, -1),
                           targets.expand(repeats, -1, -1), seed,
                           epochs=epochs, batch_size=64)
    avgs, worsts = zip(*worst_group_accuracy(clf, reps_test, t_test, g_test))
    out = {"avg_accuracy": float(np.mean(avgs)),
           "worst_group_accuracy": float(np.mean(worsts))}
    if return_detail:
        out["per_repeat_avg"] = [round(float(a), 4) for a in avgs]
        out["per_repeat_worst"] = [round(float(w), 4) for w in worsts]
    return out
