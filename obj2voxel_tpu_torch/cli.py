"""Command-line interface matching the reference CLI's flags and semantics
(reference: src/main.cpp:264-380); the port of obj2voxel_tpu/cli.py.

    obj2voxel-tpu-torch input_file output_file -r <resolution> [-s max|blend]
                        [-p xyz] [-u] [-t texture.png] [-i obj|stl]
                        [-o vl32|...] [-j threads] [-v] [-V] [--device cuda]

`--device` (default cuda) picks where the voxelizer runs; `--device cpu`
runs the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import argparse
import sys
import time

from . import constants as C
from .api import Instance, Texture, set_log_level
from .geometry import parse_permutation
from .io.writers import INPUT_FORMATS, OUTPUT_FORMATS, detect_file_type
from .utils.log import log


def _validate_file_type(path: str, explicit: str, purpose: str) -> str:
    ftype = detect_file_type(path, explicit or None)
    if ftype is None:
        if purpose == "input":
            log.warning(f'Can\'t detect file type of "{path}", assuming Wavefront OBJ')
            return "obj"
        log.error(f'Can\'t detect file type of "{path}"')
        sys.exit(1)
    supported = INPUT_FORMATS if purpose == "input" else OUTPUT_FORMATS
    if ftype not in supported:
        log.error(f"Detected {purpose} file type ({ftype}) is not supported")
        sys.exit(1)
    return ftype


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="obj2voxel-tpu-torch",
        description="PyTorch/CUDA mesh voxelizer (obj2voxel-compatible CLI)",
    )
    p.add_argument("input_file", nargs="?", help="path to the input file")
    p.add_argument("output_file", nargs="?", help="path to the output file")
    p.add_argument("-i", dest="in_format", default="", metavar="obj|stl",
                   help="explicit input format")
    p.add_argument("-o", dest="out_format", default="", metavar="ply|qef|vl32|vox|xyzrgb",
                   help="explicit output format")
    p.add_argument("-t", dest="texture", default="", metavar="texture",
                   help="fallback texture for untextured models with UVs")
    p.add_argument("-r", "--res", dest="resolution", type=int, metavar="resolution",
                   help="voxel grid resolution on all axes")
    p.add_argument("-s", "--strat", dest="strategy", choices=("max", "blend"),
                   default="max", help="color strategy (default: max)")
    p.add_argument("-p", "--perm", dest="permutation", default="xyz",
                   metavar="permutation",
                   help="axis permutation, capitals flip (e.g. xYz)")
    p.add_argument("-u", "--super", dest="supersample", action="store_true",
                   help="enable 2x supersampling")
    p.add_argument("-j", "--threads", dest="threads", type=int, default=None,
                   metavar="threads",
                   help="worker count; 0 disables multi-device parallelism "
                        "(otherwise a CUDA --device shards z windows over "
                        "every visible card)")
    p.add_argument("-v", "--verbose", dest="verbose", action="count", default=0,
                   help="enable verbose logging (-vv for per-slab progress)")
    p.add_argument("-V", "--version", dest="version", action="store_true",
                   help="print version and build info")
    p.add_argument("--80", dest="eighty", action="store_true",
                   help="80-column help output (accepted for compatibility)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    return p


def main(argv=None) -> int:
    start = time.perf_counter()
    parser = build_parser()
    args = parser.parse_args(argv)

    if args.version:
        import torch

        print("obj2voxel-tpu-torch (PyTorch/CUDA rebuild of obj2voxel)")
        print(f"Version:  {C.VERSION}")
        print(f"Builtins: torch={torch.__version__};cuda={torch.version.cuda};")
        return 0

    if not args.input_file or not args.output_file or not args.resolution:
        parser.print_help()
        return 1

    # async log backend, like the reference CLI (main.cpp:216,
    # constants.hpp:23 ENABLE_ASYNC_LOGGING)
    log.set_async(True)
    if args.verbose:
        # reference -v enables DEBUG + timestamps (main.cpp:357-361); -vv adds
        # SPAM per-slab progress (reference obj2voxel.cpp:304-308)
        set_log_level(C.LOG_LEVEL_DEBUG if args.verbose == 1 else C.LOG_LEVEL_SPAM)
        log.timestamps = True

    try:
        unit_transform = parse_permutation(args.permutation)
    except ValueError as e:
        log.error(str(e))
        return 1

    log.info(
        f'Converting "{args.input_file}" to "{args.output_file}" at resolution '
        f"{args.resolution} with strategy {args.strategy}"
    )

    in_type = _validate_file_type(args.input_file, args.in_format, "input")
    out_type = _validate_file_type(args.output_file, args.out_format, "output")

    if args.resolution >= 1024 * 1024:
        log.warning(f"Very high resolution ({args.resolution}), intentional?")
    if args.threads == 1:
        log.warning("Running with one worker thread is usually pointless; better use -j 0")

    import os

    if os.environ.get("O2V_DUMP_STL"):
        from .io import debug_stl

        debug_stl.enable(os.environ["O2V_DUMP_STL"])

    inst = Instance(args.device)
    inst.set_input_file(args.input_file, in_type)
    inst.set_output_file(args.output_file, out_type)

    texture = None
    if args.texture:
        texture = Texture()
        if texture.load_from_file(args.texture):
            inst.set_texture(texture)
            log.info(f'Loaded fallback texture "{args.texture}"')
        else:
            log.warning("Continuing without fallback texture because it could not be loaded")

    inst.set_unit_transform(unit_transform)
    # parallel by default, like the reference CLI spawning hardware_concurrency
    # workers (main.cpp:149-164): one z window a visible card (-j 0: one card)
    inst.set_parallel(args.threads != 0)
    inst.set_resolution(args.resolution)
    inst.set_supersampling(1 + int(args.supersample))
    inst.set_color_strategy(
        C.BLEND_STRATEGY if args.strategy == "blend" else C.MAX_STRATEGY
    )

    result = inst.voxelize()

    if os.environ.get("O2V_DUMP_STL"):
        from .io import debug_stl

        debug_stl.flush()

    elapsed = time.perf_counter() - start
    log.info(f"Done! ({elapsed:.3f} s)")
    log.flush()
    return int(result)


if __name__ == "__main__":
    sys.exit(main())
