"""Faults planted in the program underneath a run, to show that the check
catches them (``tests/test_rtbench_check.py`` on the CPU, ``controls.py``
on the card).  Each is a context manager that patches one function of the
program and restores it.

- ``unchanged`` (fit): the SGD step returns the parameters it was given;
- ``half_batch`` (fit): the loss and its gradient over the first half of
  the pixels only, the mean taken over those;
- ``first_step_replayed`` (fit): the step object computes its first step
  and returns that result on every later call, as a cache keyed on
  nothing would (only a step after the first shows it);
- ``pixel_step`` (frames): every finished pixel one 8-bit step (1/255)
  brighter, where the renderer produces it.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(module, name: str, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def unchanged():
    from cudaraytracer_tpu_torch.parallel import train

    def make(orig):
        def sgd(params, grads, lr):
            return orig(params, {k: (tuple(x * 0.0 for x in g)
                                     if isinstance(g, tuple) else g * 0.0)
                                 for k, g in grads.items()}, lr)
        return sgd
    return _patched(train, "_sgd", make)


def half_batch():
    from cudaraytracer_tpu_torch.parallel import train

    def make(orig):
        def value_and_grad(scene, params, camera, cfg, pixel_index, target,
                           *args, **kw):
            half = pixel_index.shape[0] // 2
            return orig(scene, params, camera, cfg, pixel_index[:half],
                        target[:half], *args, **kw)
        return value_and_grad
    return _patched(train, "value_and_grad", make)


def first_step_replayed():
    from cudaraytracer_tpu_torch.parallel import train

    def make(orig):
        def make_fit_step(*args, **kw):
            step, first = orig(*args, **kw), []

            def replayed(*a, **k):
                if not first:
                    first.append(step(*a, **k))
                return first[0]
            return replayed
        return make_fit_step
    return _patched(train, "make_fit_step", make)


def pixel_step():
    import torch
    from cudaraytracer_tpu_torch.ops import render

    def make(orig):
        def finish_pixels(colors, cfg):
            return torch.clamp(orig(colors, cfg) + 1.0 / 255.0, 0.0, 1.0)
        return finish_pixels
    return _patched(render, "finish_pixels", make)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "first_step_replayed": first_step_replayed,
          "pixel_step": pixel_step}
