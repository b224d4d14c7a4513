"""Digests of the dirty-image step's images, to compare two trees of the
port bit for bit on one card.

Run from the repository root on a machine with a CUDA card:

    PYTHONPATH=. python scripts/step_digests.py
    PYTHONPATH=<other tree> python scripts/step_digests.py

(the second form images with the package, ``chip_smoke.py`` and
``portbench`` of the other tree).  One step of
``multichannel.single_channel_step`` on each channel of four batches: the
production batch (``chip_smoke.bench_config``: 4096 px, K 60, 4 W slices
of 2^19 visibilities, 8 channels, ``make_example_batch`` seed 25) under
natural weights, under uniform weights and in full Stokes (P = 4), and
two channels of the ``mkat_l_8k_iquv.dirty`` cell (8192 px, P = 4, 6 W
slices, two polarisation groups a slice; seed 2^31 + 27).  One JSON line
a batch: the SHA-256 of each channel's image bytes; then the card's name
and power limit, and the package imaged with.
"""

import dataclasses
import hashlib
import json

import torch


def digests(step, batch, channels: int) -> list:
    from katsdpimager_tpu_torch.parallel import multichannel as mc

    out = []
    for c in range(channels):
        image = step(*mc.channel_args(batch, c))[0]
        out.append(hashlib.sha256(
            image.contiguous().cpu().numpy().tobytes()).hexdigest())
        del image
    return out


def main() -> None:
    import chip_smoke
    import katsdpimager_tpu_torch
    from katsdpimager_tpu_torch.parallel import multichannel as mc
    from portbench import manifest
    from portbench.runners import dirty_step

    dev = torch.device("cuda")
    base = chip_smoke.bench_config()
    for name, change in (("4k_natural", {}),
                         ("4k_uniform", {"weight_type": "uniform"}),
                         ("4k_iquv", {"num_pols": 4})):
        cfg = dataclasses.replace(base, **change)
        batch = mc.make_example_batch(cfg, 8, seed=25,
                                      vis_per_slice=1 << 19, device=dev)
        print(json.dumps({"batch": name, "digests": digests(
            mc.single_channel_step(cfg), batch, 8)}), flush=True)
        del batch
    cell = manifest.cell("mkat_l_8k_iquv.dirty")
    traffic = dict(cell.traffic, channels=2)
    batch, _, _ = dirty_step.program_batch(cell.config, traffic, 2 ** 31 + 27,
                                           dev)
    step = mc.single_channel_step(dirty_step.step_config(cell.config))
    print(json.dumps({"batch": "8k_iquv", "digests": digests(step, batch, 2)}),
          flush=True)
    print(json.dumps({"card": chip_smoke.card_line(),
                      "package": katsdpimager_tpu_torch.__file__}),
          flush=True)


if __name__ == "__main__":
    main()
