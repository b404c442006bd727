"""Decode walls of ``launch/serve.py``'s personalized path in one source tree.

    python3 tools/serve_decode_walls.py TREE [cuda|cpu]

imports ``repro_torch`` from ``TREE/src`` (a checkout, or a ``git archive``
of another revision) and calls ``serve.main`` for mamba2-130m (3 calls, the
first a warm-up) and zamba2-1.2b with ``--personal-subset
shared,embed/unembed`` (2 calls), 4 users and 16 tokens each, at full width
on the card (``--smoke`` on the CPU).  Prints one line, ``AB`` and a JSON
object of each call's ``decode_s`` (cache init, prefill and decode steps).
To compare two revisions on one card, run it for each in one command, in
the order old, new, new, old.
"""
import json
import sys


def main() -> None:
    tree = sys.argv[1]
    dev = sys.argv[2] if len(sys.argv) > 2 else "cuda"
    sys.path.insert(0, tree + "/src")
    from repro_torch.launch import serve
    out = {"tree": tree}
    for arch, extra, n in (("mamba2-130m", [], 3),
                           ("zamba2-1.2b", ["--personal-subset",
                                            "shared,embed/unembed"], 2)):
        walls = []
        for _ in range(n):
            run = serve.main(["--arch", arch, "--personalize", "--requests",
                              "4", "--tokens", "16", "--device", dev]
                             + extra + (["--smoke"] if dev == "cpu" else []))
            walls.append(run.decode_s)
        out[arch] = walls
    print("AB " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
