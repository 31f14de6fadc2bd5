"""Movie frames sharded over worker processes (the port's counterpart of
the JAX package's scripts/movie_launcher.py, with the same flags).

Frames are independent, so K local workers each render every K-th frame
through the movie CLI's ``--frame-stride``/``--frame-offset``; across
hosts, one launcher per host with ``--hosts``/``--host-index``, and the
strides compose.  Arguments after ``--`` go to
``python -m clive2_tpu_torch.apps.movie`` unchanged (``--device cpu``
among them: the workers render on the card otherwise).  The launcher of
host 0 empties the movie's folder before it starts its workers (when the
movie starts at frame 0), and exits with the largest exit code of its
workers.

    python -m clive2_tpu_torch.scripts.movie_launcher --workers 4 -- \\
        --scene dragon --movie-frames 120 --samples 8
    # host 1 of 2, 4 workers each:
    python -m clive2_tpu_torch.scripts.movie_launcher --workers 4 \\
        --hosts 2 --host-index 1 -- --scene dragon --movie-frames 120
"""

from __future__ import annotations

import argparse
import subprocess
import sys

from ..apps import movie


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--workers", type=int, default=1,
                        help="local worker processes")
    parser.add_argument("--hosts", type=int, default=1,
                        help="total hosts sharding this movie")
    parser.add_argument("--host-index", type=int, default=0)
    parser.add_argument("movie_args", nargs=argparse.REMAINDER,
                        help="arguments forwarded to "
                        "clive2_tpu_torch.apps.movie (prefix with --)")
    args = parser.parse_args(argv)
    fwd = [a for a in args.movie_args if a != "--"]

    movie_args = movie.make_parser().parse_args(fwd)
    if args.host_index == 0 and movie_args.start_frame == 0:
        movie.empty_movie_dir(movie_args)
    stride = args.workers * args.hosts
    procs = []
    for w in range(args.workers):
        offset = args.host_index * args.workers + w
        cmd = [
            sys.executable, "-m", "clive2_tpu_torch.apps.movie",
            "--frame-stride", str(stride),
            "--frame-offset", str(offset),
        ] + fwd
        print("launch:", " ".join(cmd), flush=True)
        procs.append(subprocess.Popen(cmd))

    rc = 0
    try:
        for p in procs:
            code = p.wait()
            # a worker killed by signal k counts as 128 + k, as in a shell
            rc = max(rc, code if code >= 0 else 128 - code)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rc


if __name__ == "__main__":
    sys.exit(main())
