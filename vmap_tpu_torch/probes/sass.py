"""The kernels' machine code (SASS), counted by kernel and by loop.

Builds a kernel library (the probes', ``probes.LIBRARY``, or with
``--library kernels`` the system's, ``kernels._build.KERNELS``),
disassembles it with the toolkit's ``cuobjdump -sass`` and, for each
kernel whose name (mangled or demangled) contains one of the given
patterns, reports its instructions (``NOP`` left out), its branches
(``BRA``), calls (``CALL``, the slow paths of the accurate math
functions), convergence regions (``BSSY``) and its opcodes, for the whole
function and for each loop, a loop being the span from a backward
branch's target to that branch. A chain's step loop is the kernel's
outermost one, so its instructions over the elements a thread holds and
the steps an iteration runs are the instructions an element a step.
``--out`` also writes those kernels' whole disassembly. A step's path,
where a loop holds code that runs only on rare inputs (the slow paths of
the accurate functions), is counted by ``--path``: the instructions of
the span START-END (addresses as the disassembly gives them) less those
of the SKIP spans. ``--versus-unsplit`` builds the library also without
ptxas's ``--split-compile`` (``_build.BASE_FLAGS``) and reports, kernel
by kernel, whether the two builds' instructions are the same.

    python -m vmap_tpu_torch.probes.sass [pattern ...] [--out FILE]
        [--path START-END [SKIP-SKIP ...]] [--library probes|kernels]
        [--versus-unsplit]

Needs the CUDA toolkit (``nvcc`` builds the library, ``cuobjdump`` reads
it); no card.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from vmap_tpu_torch import probes
from vmap_tpu_torch.kernels._build import (BASE_FLAGS, KERNELS, NVCC_FLAGS,
                                           _nvcc)

LIBRARIES = {"probes": probes.LIBRARY, "kernels": KERNELS}

_FUNCTION = re.compile(r"^\s*Function\s*:\s*(.+?)\s*$")
_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_TARGET = re.compile(r"0x([0-9a-f]+)\s*$")  # a branch's target address


def split_functions(sass: str) -> dict:
    """``cuobjdump -sass`` output -> {function name: its lines}."""
    funcs, name = {}, None
    for line in sass.splitlines():
        m = _FUNCTION.match(line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return funcs


def _opcode(text: str) -> str:
    """An instruction's opcode without its predicate and modifiers."""
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0] if words else ""


def _summary(instrs: list) -> dict:
    ops = collections.Counter(op for _, op, _ in instrs if op != "NOP")
    return {"instructions": sum(ops.values()), "branches": ops["BRA"],
            "calls": ops["CALL"], "bssy": ops["BSSY"],
            "opcodes": dict(sorted(ops.items()))}


def _instructions(lines: list) -> list:
    """(address, opcode, text) of each instruction."""
    out = []
    for line in lines:
        m = _INSTR.match(line)
        if m:
            out.append((int(m.group(1), 16), _opcode(m.group(2)), m.group(2)))
    return out


def path_count(lines: list, span: tuple, skips: tuple = ()) -> dict:
    """The counts (``_summary``) of the instructions whose address lies in
    ``span`` (first, last) and in none of ``skips``."""
    instrs = _instructions(lines)
    return _summary([i for i in instrs if span[0] <= i[0] <= span[1]
                     and not any(a <= i[0] <= b for a, b in skips)])


def count(lines: list) -> dict:
    """One function's lines -> its counts (``_summary``) and its loops:
    for each backward branch the span [target, branch] with its counts,
    largest (outermost) first. A branch to itself, the padding after the
    last ``EXIT``, is no instruction of the kernel's."""
    def target(text):
        t = _TARGET.search(text)
        return int(t.group(1), 16) if t else None

    instrs = [i for i in _instructions(lines)
              if not (i[1] == "BRA" and target(i[2]) == i[0])]
    loops = []
    for addr, op, text in instrs:
        start = target(text) if op == "BRA" else None
        if start is not None and start < addr:
            body = [i for i in instrs if start <= i[0] <= addr]
            loops.append({"start": f"{start:04x}", "end": f"{addr:04x}",
                          **_summary(body)})
    loops.sort(key=lambda lp: (-lp["instructions"], lp["start"]))
    return {**_summary(instrs), "loops": loops}


def _tool(name: str, *args: str, stdin: str = "") -> str:
    """The output of the toolkit's ``name`` (beside nvcc) on ``args``."""
    return subprocess.run([str(Path(_nvcc()).parent / name), *args],
                          input=stdin, text=True, capture_output=True,
                          check=True).stdout


def disassemble(lib: Path) -> dict:
    """A built library's SASS: {demangled name: (mangled name, lines)}."""
    funcs = split_functions(_tool("cuobjdump", "-sass", str(lib)))
    names = _tool("cu++filt", stdin="\n".join(funcs)).splitlines()
    return {name: (mangled, lines)
            for name, (mangled, lines) in zip(names, funcs.items())}


def kernels(patterns: list, library=probes.LIBRARY) -> tuple:
    """Build ``library`` and count the kernels matching ``patterns`` (all
    where none is given): ({demangled: counts}, {demangled:
    disassembly})."""
    lib, _ = library.build()
    counts, text = {}, {}
    for name, (mangled, lines) in disassemble(lib).items():
        if patterns and not any(p in name or p in mangled for p in patterns):
            continue
        counts[name] = count(lines)
        text[name] = "\n".join(lines)
    return counts, text


def same_code(split: dict, unsplit: dict) -> dict:
    """Two disassemblies (``disassemble``) of one library's builds, with
    and without the split flags: the kernels of each, how many have
    the same instructions (address and text, encodings left out) in both,
    and for each other kernel its instruction counts in both (None where a
    build lacks it)."""
    def code(d, name):
        return ([(a, t) for a, _, t in _instructions(d[name][1])]
                if name in d else None)
    differ = {name: [count(d[name][1])["instructions"] if name in d else None
                     for d in (split, unsplit)]
              for name in sorted(set(split) | set(unsplit))
              if code(split, name) != code(unsplit, name)}
    return {"kernels": [len(split), len(unsplit)],
            "same": len(set(split) | set(unsplit)) - len(differ),
            "differ": differ}


def versus_unsplit(library) -> dict:
    """``library`` built with ``NVCC_FLAGS`` and with ``BASE_FLAGS``, both
    builds at once: ``same_code`` of the two."""
    with ThreadPoolExecutor(2) as pool:
        libs = list(pool.map(lambda fl: library.build(flags=fl)[0],
                             (NVCC_FLAGS, BASE_FLAGS)))
    return same_code(*map(disassemble, libs))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("patterns", nargs="*",
                    help="parts of kernel names (default: every kernel)")
    ap.add_argument("--out", help="write the kernels' disassembly here")
    ap.add_argument("--path", nargs="+", metavar="START-END",
                    help="count a span of each kernel, less the spans after "
                    "the first (hexadecimal addresses)")
    ap.add_argument("--library", choices=sorted(LIBRARIES),
                    default="probes")
    ap.add_argument("--versus-unsplit", action="store_true",
                    help="also build with BASE_FLAGS and compare")
    args = ap.parse_args(argv)
    library = LIBRARIES[args.library]
    if args.versus_unsplit:
        print(json.dumps({"library": library.name,
                          **versus_unsplit(library)}), flush=True)
    counts, text = kernels(args.patterns, library)
    spans = [tuple(int(a, 16) for a in s.split("-")) for s in args.path or ()]
    for name, c in counts.items():
        loop = c["loops"][0] if c["loops"] else None
        row = {"kernel": name, **{k: c[k] for k in (
            "instructions", "branches", "calls", "bssy")}, "outer_loop": loop}
        if spans:
            row["path"] = path_count(text[name].splitlines(), spans[0],
                                     tuple(spans[1:]))
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).write_text("".join(
            f"Function : {name}\n{body}\n\n" for name, body in text.items()))
    return counts


if __name__ == "__main__":
    main()
