"""Faults planted under the timed path, each one a cell can have, for
the checks that ``correct`` catches them: a training step that leaves
its state unchanged; half of the batch left out, the mean taken over the
rest; a frame's first render chunk altered where it is produced; half
of a frame's rays left out.  Each maps a cell's configuration to the
hooks ``run.execute`` takes (``faults``)."""

from __future__ import annotations


def unchanged(config: dict) -> dict:
    def hook(tr):
        enter = tr._enter_phase

        def entered(phase):
            enter(phase)
            tr.optimizers.step = lambda count: None
        tr._enter_phase = entered
    return {"train": hook}


def half_batch(config: dict) -> dict:
    def hook(tr):
        draws = tr.draws
        tr.draws = lambda step: {k: v[:len(v) // 2]
                                 for k, v in draws(step).items()}
    return {"train": hook}


def _frames(edit):
    def fault(config: dict) -> dict:
        def hook(renderer):
            render = renderer.render_img

            def broken(*a, **kw):
                out = render(*a, **kw)
                edit(out["Col_Img"], config["chunk"])
                return out
            renderer.render_img = broken
        return {"render": hook}
    return fault


def _altered(img, chunk: int):
    rows = max(chunk // img.shape[1], 1)
    img[:rows] = (img[:rows] + 0.25).clip(0, 1)


def _half_rays(img, chunk: int):
    img[img.shape[0] // 2:] = 0.0


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": _frames(_altered), "half_rays": _frames(_half_rays)}
