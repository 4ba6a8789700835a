#!/usr/bin/env python3
"""3d-beats on PyTorch/CUDA (beats3d_tpu_torch) — the live 2-hand
10-finger MIDI instrument, headless: camera (or recorded / synthetic)
frames in, MIDI out, optional PNG label renders.

Examples:
  python apps/bz3d_torch.py -cfg models/flagship/model_cfg.json --synthetic --frames 200
  python apps/bz3d_torch.py -cfg model/model_cfg.json --session session.npz
  python apps/bz3d_torch.py -cfg model/model_cfg.json --device cpu --synthetic
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from beats3d_tpu_torch.models import LayeredDecisionForest  # noqa: E402
from beats3d_tpu_torch.runtime import camera  # noqa: E402
from beats3d_tpu_torch.runtime.app import AppConfig, BeatsApp  # noqa: E402
from beats3d_tpu_torch.runtime.midi import Midi  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description="3d-beats (PyTorch/CUDA)")
    parser.add_argument("-cfg", required=True, type=str,
                        help="layered decision forest config JSON")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (the CUDA kernels) or cpu "
                             "(their plain versions)")
    parser.add_argument("--plane_num_iterations", type=int, default=25000)
    parser.add_argument("--no_debug", action="store_true")
    parser.add_argument("--dump_labels", type=str, default=None,
                        help="directory for periodic label RGBA dumps")
    camera.add_args(parser)
    args = parser.parse_args()

    cfg = AppConfig(plane_num_iterations=args.plane_num_iterations)
    source = camera.open_source(args)
    model = LayeredDecisionForest.load(
        args.cfg, labels_reduce=cfg.labels_reduce, device=args.device)
    app = BeatsApp(model, source, midi=Midi(), cfg=cfg)

    n = 0
    try:
        for frame in source.frames():
            out = app.tick(frame)
            n += 1
            if out is not None and not args.no_debug and n % 30 == 0:
                on = [
                    str(h.fingertips[i].midi_note)
                    for h in app.hand_states
                    for i in range(5)
                    if h.fingertips[i].note_on
                ]
                print(
                    f"frame {n}: {app.frame_times.last_ms:.1f} ms/frame, "
                    f"notes on: {on or '-'}"
                )
                if args.dump_labels:
                    from PIL import Image

                    os.makedirs(args.dump_labels, exist_ok=True)
                    rgba = app.labels_rgba()
                    if rgba is not None:
                        Image.fromarray(rgba).save(
                            os.path.join(args.dump_labels, f"labels_{n:06d}.png")
                        )
            if args.frames and n >= args.frames:
                break
        app.flush()
    finally:
        source.stop()
    print(f"processed {n} frames; {len(app.midi.sink.events)} midi events")


if __name__ == "__main__":
    main()
