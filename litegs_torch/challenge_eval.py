"""Speed-challenge evaluation on the card (the port of the root
``3dgs_challenge_eval.py``; reference 3dgs_challenge_eval.py:12-36): score
the trained model's test split and merge SSIM and PSNR with the recorded
train time.

    python -m litegs_torch.challenge_eval -s <colmap_scene_dir> \
        -m <output_dir> --timing_json <output_dir>/train_time.json \
        --output_json <output_dir>/challenge.json

Takes the root script's flags; the others are passed on to
``example_metrics``.  The root script runs ``example_metrics.py`` in a
subprocess; this one calls ``litegs_torch.example_metrics.main`` in process
on the same ``device``, reads its printed lines with the root script's
pattern and echoes them as the root script does.
"""
import argparse
import contextlib
import io
import json
import re

from . import example_metrics

TEST_RE = re.compile(r"test: SSIM ([0-9.]+)\s+PSNR ([0-9.]+)")


def main(argv=None, device="cuda"):
    """Score ``-m``'s model on ``device``; returns the merged record
    written to ``--output_json``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-s", "--source_path", required=True)
    parser.add_argument("-m", "--model_path", required=True)
    parser.add_argument("--timing_json", type=str, default="train_time.json")
    parser.add_argument("--output_json", type=str, default="challenge.json")
    args, extra = parser.parse_known_args(argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        example_metrics.main(["-s", args.source_path, "-m", args.model_path,
                              "--skip_train", *extra], device=device)
    print(out.getvalue())
    m = TEST_RE.search(out.getvalue())
    result = {}
    try:
        with open(args.timing_json) as f:
            result.update(json.load(f))
    except OSError:
        pass
    if m:
        result["ssim"], result["psnr"] = float(m.group(1)), float(m.group(2))
    with open(args.output_json, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
