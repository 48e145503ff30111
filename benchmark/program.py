"""What the benchmark reads of the program's first training steps.

The window drives the program's own epoch and online runners. Before it,
the first steps of the same run, through the same call and feed, are
observed: each step's loss, each step's gradient as the optimizer got it
(Adam's first moment after step k is ``b1`` times the one before plus
``(1 - b1)`` times the gradient, so step k's gradient is ``(m_k - b1
m_{k-1}) / (1 - b1)``), the parameters before the first step and after
the third, and the spectral-norm state (each site's ``u`` and ``v``
buffers) before and after, which the steps' post-update refreshes. The
reference follows the same steps, and the comparison (``compare.py``)
judges the readings.

The graphed runners replay a captured step, which runs no Python, so the
observer hooks what they do run before every step: the draw of the
step's noise (:class:`Observer.plan` wraps the program's ``NoisePlan``).
At the draw of step k, step k - 1 has been enqueued on the stream, and the
copies taken there are ordered after it. The step function itself runs
only twice in that mode (the eager first step and the capture), so its
outputs are the first step's values and then the graph's static outputs,
which hold the latest replay's. On the CPU the runners are eager and the
wrapped step function marks each step.
"""
from __future__ import annotations

import torch

from benchmark import plain

B1 = 0.9  # Adam's first-moment decay in the program's optimizer
STEPS = 3  # the first steps the comparison reads


class Observer:
    """Takes the readings of the first :data:`STEPS` steps of one run of
    ``model`` under ``optimizer`` (set with :meth:`attach`)."""

    def __init__(self):
        self.outputs: list = []
        self.losses: list = []
        self.k = 0
        self.graphed = False
        self.grads: list = []  # each step's gradient norms by leaf
        self.start = self.after = self.moment = None

    def attach(self, model, optimizer):
        self.model, self.optimizer = model, optimizer

    def plan(self, factory):
        """A ``graph_noise`` for the program's runners: ``factory(batch,
        device=...)`` is the CLI's (a ``partial`` of ``NoisePlan``); the
        plan it makes calls :meth:`before` ahead of every draw."""
        self.graphed = True
        observer = self

        def make(*args, **kwargs):
            plan = factory(*args, **kwargs)
            draw = plan.draw

            def observed(generator):
                observer.before()
                draw(generator)

            plan.draw = observed
            return plan

        return make

    def wrap(self, fn, loss_of):
        """``fn`` (a step or a loss function) recording ``loss_of(its
        output)``; in the eager mode it also marks each step."""
        def wrapped(*args, **kwargs):
            if not self.graphed:
                self.before()
            out = fn(*args, **kwargs)
            if len(self.outputs) < 2 or not self.graphed:
                self.outputs.append(loss_of(out))
            return out
        return wrapped

    def before(self):
        """Step ``self.k + 1`` is about to be staged."""
        self.k += 1
        k = self.k
        if k > STEPS + 1:
            return
        with torch.no_grad():
            if k == 1:
                self.start = self._leaves()
                return
            # the previous step's loss: the first step's own output, later
            # the latest (the graph's static output, or the eager step's)
            self.losses.append((self.outputs[0] if k == 2
                                else self.outputs[-1]).detach().clone())
            moment = {n: m.clone() for n, m in
                      adam_moments(self.model, self.optimizer)}
            before = self.moment or {n: torch.zeros_like(m)
                                     for n, m in moment.items()}
            self.grads.append(plain.norms(
                {n: (m - B1 * before[n]) / (1 - B1)
                 for n, m in moment.items()}))
            self.moment = moment
            if k == STEPS + 1:
                self.after = self._leaves()
                self.moment = None

    def _leaves(self) -> dict:
        """Copies of the trained leaves and of the spectral-norm state."""
        leaves = {n: p.detach().clone() for n, p in trained_leaves(
            self.model, self.optimizer)}
        leaves.update({n: b.clone() for n, b in sn_state(self.model)})
        return leaves

    def readings(self) -> dict:
        if self.after is None:
            raise RuntimeError(f"the run ended before its step "
                               f"{STEPS + 1}: no readings")
        change = {n: self.after[n] - self.start[n] for n in self.start}
        sn = dict(sn_state(self.model))
        return plain.readings(
            self.losses, self.grads,
            {n: d for n, d in change.items() if n not in sn},
            {n: d for n, d in change.items() if n in sn})


def sn_state(model):
    """(name, buffer) of each spectral-norm site's ``u`` and ``v``."""
    return [(n, b) for n, b in model.named_buffers()
            if n.endswith((".u", ".v"))]


def trained_leaves(model, optimizer):
    """(name, parameter) of every leaf the optimizer trains, by the
    model's names (a packed leaf is a view of its flat buffer)."""
    ids = {id(p) for g in optimizer.param_groups for p in g["params"]}
    packer = getattr(optimizer, "packer", None)
    packed = set() if packer is None else {
        m[0] for members in packer.members.values() for m in members}
    return [(n, p) for n, p in model.named_parameters()
            if p.requires_grad and (id(p) in ids or n in packed)]


def adam_moments(model, optimizer):
    """(leaf name, Adam's first moment of it), the packed leaves cut from
    their flat buffer's moment."""
    def moment(param):
        # a parameter the optimizer never stepped has no state: zero
        state = optimizer.state.get(param, {})
        return state.get("exp_avg", torch.zeros_like(param))

    packer = getattr(optimizer, "packer", None)
    if packer is not None:
        for param, members in packer.layout():
            m = moment(param).reshape(-1)
            for name, shape, n, offset in members:
                yield name, m[offset:offset + n].view(shape)
        return
    names = {id(p): n for n, p in model.named_parameters()}
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.requires_grad:
                yield names[id(p)], moment(p)


@torch.no_grad()
def load_weights(model, weights: dict) -> None:
    """Copy the benchmark's weights into the model's parameters and
    buffers of the same names; every name must exist there."""
    params = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    for name, w in weights.items():
        target = params.get(name, buffers.get(name))
        if target is None or target.shape != w.shape:
            raise KeyError(f"the model has no leaf {name} of shape "
                           f"{tuple(w.shape)}")
        target.copy_(w)
