"""Whether two trees compile the median kernels to the same machine code.

    python zen_tpu_torch/benches/sass_diff.py OLD_TREE NEW_TREE
    python zen_tpu_torch/benches/sass_diff.py TREE --count PATTERN

Builds each tree's kernel library (``_build.library``, in a process of
its own that imports ``zen_tpu_torch`` from that tree), dumps both with
``cuobjdump -sass`` and compares, kernel by kernel, the instructions of
every kernel whose name both libraries hold (the anonymous namespace's
hash in a name, which follows the file's text, and the instructions'
addresses and encodings are left out). Two trees' timings of a kernel
with the same instructions differ by the card's state, not by the code
(``benches/rank_store.py`` times them in turns). Needs the CUDA toolkit;
prints one line a kernel that differs, then one JSON object.
``--count`` prints, for each kernel of TREE whose mangled name
matches PATTERN, its instruction count and commonest opcodes.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path


def library(tree: str) -> str:
    """The path of ``tree``'s kernel library, built if needed."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from zen_tpu_torch.ops import _build; "
            "_build.library(); print(_build.library_path())")
    out = subprocess.run([sys.executable, "-c", code, str(Path(tree).resolve())],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


def kernels(so: str) -> dict:
    """{kernel name without the namespace hash: its instructions}."""
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    text = subprocess.run([os.path.join(cuda, "bin", "cuobjdump"), "-sass", so],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        lines = block.split("\n")
        name = re.sub(r"_GLOBAL__N__[0-9a-f_]+", "", lines[0].strip())
        body = (re.sub(r"/\*[0-9a-f]{4}\*/|/\* 0x[0-9a-f]+ \*/", "", line).strip()
                for line in lines[1:])
        out[name] = [line for line in body if line]
    return out


def opcodes(lines: list) -> dict:
    """{opcode (its mnemonic before the first dot): count} of a kernel's
    instructions, a predicate guard left out."""
    out = {}
    for line in lines:
        words = line.rstrip(" ;").split()
        if words and words[0].startswith("@"):
            words = words[1:]
        if words and re.fullmatch(r"[A-Z][A-Z0-9_.]*", words[0]):
            op = words[0].split(".")[0]
            out[op] = out.get(op, 0) + 1
    return out


def count(tree: str, pattern: str) -> dict:
    """{kernel: (instructions, its ten commonest opcodes)} of ``tree``'s
    kernels whose name matches ``pattern``."""
    found = {}
    for name, lines in kernels(library(tree)).items():
        if re.search(pattern, name):
            ops = opcodes(lines)
            found[name] = (sum(ops.values()), sorted(ops.items(), key=lambda kv: -kv[1])[:10])
            print(f"{name}: {found[name][0]} instructions; {found[name][1]}")
    return found


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("old")
    ap.add_argument("new", nargs="?")
    ap.add_argument("--count", metavar="PATTERN",
                    help="print the instruction count and commonest opcodes of each kernel "
                         "of OLD whose name matches PATTERN, and compare nothing")
    args = ap.parse_args(argv)
    if args.count:
        return count(args.old, args.count)
    old, new = kernels(library(args.old)), kernels(library(args.new))
    both = sorted(set(old) & set(new))
    differ = [name for name in both if old[name] != new[name]]
    for name in differ:
        print(f"differs: {name} ({len(old[name])} against {len(new[name])} lines)")
    report = {"same": len(both) - len(differ), "differ": len(differ),
              "only_old": len(set(old) - set(new)), "only_new": len(set(new) - set(old))}
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
