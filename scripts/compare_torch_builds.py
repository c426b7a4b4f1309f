"""Two trees' kernel libraries compared: registers and spills, and SASS.

Run on a machine with a CUDA card and the CUDA toolkit, from the root of
the repository:

    python3 scripts/compare_torch_builds.py OTHER_TREE [THIS_TREE] [--kind gemm_bf16_kernel ...]

Builds both trees' ``eqxvision_tpu_torch`` libraries (at once, each in a
process of its own, where not built yet), then prints, for every kernel of
either build: the kernels whose registers or spill bytes (ptxas's report in
the build log) differ, and for each ``--kind`` (default: the GEMMs, the
attention stage, the row statistics) how many kernels have the same SASS
(``cuobjdump -sass`` of the library, addresses and encodings dropped) and
the instruction counts of those that differ. Kernels are matched by name
with each source's anonymous-namespace hash taken out, and with the GEMMs'
argument structs (``Bf16Gemm``, ``F32Gemm``, ``GemmMaps``) named alike. For
example, OTHER_TREE a ``git archive`` of the parent, to show that a change
leaves every bf16 kernel as it compiled. Imports nothing of JAX.
"""
import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KINDS = ("gemm_bf16_kernel", "gemm_f32_kernel", "attention_stage", "row_stats")


def _name(mangled):
    name = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_\d+_(\w+?)_cu_[0-9a-f]{8}", r"\1", mangled)
    return re.sub(r"NS_\d+(Bf16Gemm|F32Gemm|GemmMaps)E", "NS_GEMM", name)


def _library(tree):
    """Library and build log of ``tree``, built first where missing."""
    code = "import sys; sys.path.insert(0, sys.argv[1]); from eqxvision_tpu_torch import _native; print(_native.library_path())"
    return subprocess.Popen([sys.executable, "-c", code + "; _native.library()", str(tree)], stdout=subprocess.PIPE,
                            text=True)


def _registers(log):
    out, name, spills = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = _name(m.group(1))
        elif name and "spill stores" in line:
            spills = sum(int(v) for v in re.findall(r"(\d+) bytes spill", line))
        elif name and "Used" in line and "registers" in line:
            out[name] = (int(re.search(r"Used (\d+) registers", line).group(1)), spills)
            name = None
    return out


def _sass(lib):
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _name(m.group(1))
            funcs[name] = []
        elif name and "/*" in line:
            ins = re.sub(r"/\*[^*]*\*/", "", line).strip()
            if ins:
                funcs[name].append(ins)
    return funcs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("this", type=Path, nargs="?", default=ROOT)
    ap.add_argument("--kind", action="append", help="repeatable; default: " + ", ".join(KINDS))
    args = ap.parse_args()
    procs = [_library(tree) for tree in (args.other, args.this)]
    libs = []
    for proc in procs:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit("a tree did not build")
        libs.append(Path(out.split()[0]))
    a, b = (_registers(lib.with_suffix(".log").read_text()) for lib in libs)
    differ = [k for k in sorted(set(a) | set(b)) if a.get(k) != b.get(k)]
    print(f"registers and spills: {len(set(a) | set(b))} kernels, {len(differ)} differ")
    for k in differ:
        print(f"  {k[:140]}: {a.get(k)} -> {b.get(k)}")
    a, b = (_sass(lib) for lib in libs)
    for kind in args.kind or KINDS:
        keys = sorted(k for k in set(a) | set(b) if kind in k)
        same = [k for k in keys if a.get(k) == b.get(k)]
        print(f"{kind}: {len(keys)} kernels, {len(same)} with the same SASS")
        for k in keys:
            if k not in same:
                print(f"  differs: {k[:140]} {len(a.get(k, []))} -> {len(b.get(k, []))} instructions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
