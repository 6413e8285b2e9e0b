"""CLI: python -m deepclr_tpu_torch.kitti_devkit GT_DIR PRED_DIR [RESULT_DIR] [--no-plots].

Writes the error tables and stats into RESULT_DIR (default PRED_DIR/result)
and, unless --no-plots, the path and error plots beside them.  Without
matplotlib the tables are still written and the plots are skipped with one
log line.
"""
import argparse

from ..utils.logging import create_logger
from . import eval as kitti_eval


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="KITTI odometry benchmark evaluation.")
    parser.add_argument("gt_dir", type=str, help="ground-truth pose directory")
    parser.add_argument("pred_dir", type=str, help="predicted pose directory")
    parser.add_argument("result_dir", type=str, nargs="?", default=None,
                        help="output directory (default: PRED_DIR/result)")
    parser.add_argument("--no-plots", action="store_true", help="skip path/error plot generation")
    args = parser.parse_args(argv)

    n = kitti_eval(args.gt_dir, args.pred_dir, args.result_dir)
    if not args.no_plots and n > 0:
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            create_logger("kitti_devkit").info("matplotlib does not import: the devkit plots are skipped")
        else:
            from .plots import write_plots

            write_plots(args.gt_dir, args.pred_dir, args.result_dir)
    print(f"evaluated {n} sequences")
    return n


if __name__ == "__main__":
    main()
