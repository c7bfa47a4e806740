#!/usr/bin/env python3
"""SiT-small's streamed training step beside the device-resident one, by
the streaming loader's number of gather threads, on one NVIDIA GPU.

    python3 scripts/stream_step_threads.py [THREADS ...]

Builds ``chip_smoke.py`` phase 33's model (``sit_small_birth_age_native.yml``
at full width, augmentation on, the canonical ico-6 sphere, seeded weights)
and its 512-surface synthetic training split as a memmapped .npy; then, for
each gather thread count (``data.pipeline.GATHER_THREADS``; default 1 2 4
8), times epochs of two bs-256 steps streamed from the memmap and on the
device-resident split, in turns streamed, resident, resident, streamed,
``REPS`` times, and prints the mean ms a step of each by the host clock
(synchronized), the loader's host stall a step, and the card's name and
power limit. Needs a CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
REPS = 3


def main(threads: list[int]) -> None:
    import chip_smoke as cs
    from surface_vision_transformers_tpu_torch.data import gifti, npy, pipeline
    from surface_vision_transformers_tpu_torch.data.synthetic import make_regression_dataset
    from surface_vision_transformers_tpu_torch.geometry import load_patch_table
    from surface_vision_transformers_tpu_torch.geometry.icosphere import icosphere
    from surface_vision_transformers_tpu_torch.ops import _native
    from surface_vision_transformers_tpu_torch.train import runner
    from surface_vision_transformers_tpu_torch.train.trainer import Trainer
    from surface_vision_transformers_tpu_torch.utils import config

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    _native.build()
    print(cs.card(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "data").mkdir()
        data, labels = make_regression_dataset(cs.AUG_N_TRAIN, raw_vertices=40962,
                                               seed=cs.SEED + 33)
        np.save(tmp / "data" / "train_data.npy", data)
        np.save(tmp / "data" / "train_labels.npy", labels)
        del data
        gifti.save_sphere(*icosphere(6), tmp / "sphere.surf.gii")
        exp = config.from_dict(cs.aug_config(tmp, "threads", 1))
        table = load_patch_table(exp.ico, exp.sub_ico)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cs.SEED)
            model = runner.build_model(exp, table.indices).cuda()
        trainer = Trainer(exp, model, augment=runner.build_augment(exp, table))
        mm, mm_labels = npy.load_split(tmp / "data", "train", mmap=True)
        d_train = torch.from_numpy(np.array(mm, np.float32)).cuda()
        l_train = torch.from_numpy(mm_labels).cuda()
        for n in threads:
            pipeline.GATHER_THREADS = n
            loader = pipeline.StreamingLoader(mm, mm_labels, batch_size=cs.AUG_B,
                                              seed=cs.SEED, device="cuda")
            steps = loader.steps_per_epoch()

            def epoch_s(streamed):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if streamed:
                    trainer.train_epoch_streaming(loader)
                else:
                    trainer.train_epoch(d_train, l_train)
                torch.cuda.synchronize()
                return time.perf_counter() - t0

            epoch_s(True)
            epoch_s(False)
            times, stall = {True: 0.0, False: 0.0}, 0.0
            for _ in range(REPS):
                for streamed in (True, False, False, True):
                    times[streamed] += epoch_s(streamed)
                    stall += loader.wait_s if streamed else 0.0
            loader.close()
            per = 1e3 / (2 * REPS * steps)
            print(f"gather threads {n}: streamed {times[True] * per:.3f} ms a step, "
                  f"resident {times[False] * per:.3f} ms a step, host stall "
                  f"{stall * per:.3f} ms a step ({2 * REPS} epochs of {steps} steps each "
                  f"way)", flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [1, 2, 4, 8])
