"""The ctypes bindings of the port's CUDA kernels against their C entry
points, read from the sources (no compiler needed).

Every ``build.function(lib, name, argtypes)`` call in
``src/repro_torch/kernels/*.py`` must name a function declared inside
``extern "C"`` in ``csrc/<lib>.cu`` with as many parameters as
``argtypes`` has entries, each of the matching kind: a pointer for
``c_void_p``, ``int`` for ``c_int``, ``int64_t`` for ``c_int64``, ``float``
for ``c_float``.  A wrong ctypes arity or kind is not caught by the
compiler or the CPU tests, and on the card it passes garbage silently.
"""
import ast
import ctypes
import importlib
import re
from pathlib import Path

import pytest

pytestmark = pytest.mark.tier1

KERNELS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
_KIND = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
         ctypes.c_int64: "int64", ctypes.c_float: "float"}


def c_entry_points(source: str) -> dict[str, list[str]]:
    """``{name: [kind of each parameter]}`` for the functions defined in the
    ``extern "C" { ... }`` blocks of a CUDA source."""
    source = re.sub(r"//[^\n]*|/\*.*?\*/", "", source, flags=re.S)
    found = {}
    for start in re.finditer(r'extern\s+"C"\s*\{', source):
        depth, i = 1, start.end()
        while depth:
            depth += {"{": 1, "}": -1}.get(source[i], 0)
            i += 1
        block = source[start.end():i - 1]
        top, depth = [], 0                  # the block's text outside bodies
        for ch in block:
            if ch == "}":
                depth -= 1
            if depth == 0:
                top.append(ch)
            if ch == "{":
                depth += 1
        for m in re.finditer(r"\bint\s+(\w+)\s*\(([^)]*)\)\s*\{",
                             "".join(top)):
            found[m.group(1)] = [_param_kind(p) for p in m.group(2).split(",")
                                 if p.strip()]
    return found


def _param_kind(param: str) -> str:
    if "*" in param:
        return "pointer"
    typ = param.split()[:-1]
    if typ in (["int64_t"], ["long", "long"]):
        return "int64"
    if typ in (["int"], ["unsigned"]):
        return "int"
    if typ == ["float"]:
        return "float"
    raise ValueError(f"unexpected C parameter {param.strip()!r}")


def bindings() -> list[tuple[str, str, str, tuple]]:
    """``(wrapper file, lib, C name, argtypes)`` for every
    ``build.function`` call of the kernel wrappers; a name given as
    ``TABLE[...]`` stands for every value of that module-level dict."""
    out = []
    for path in sorted(KERNELS.glob("*.py")):
        tree = ast.parse(path.read_text())
        calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
                 and isinstance(n.func, ast.Attribute)
                 and n.func.attr == "function"
                 and isinstance(n.func.value, ast.Name)
                 and n.func.value.id == "build"]
        if not calls:
            continue
        mod = importlib.import_module(f"repro_torch.kernels.{path.stem}")
        for call in calls:
            lib_arg, name_arg, types_arg = call.args
            lib = ast.literal_eval(lib_arg)
            if isinstance(name_arg, ast.Subscript):
                names = sorted(set(getattr(mod, name_arg.value.id).values()))
            else:
                names = [ast.literal_eval(name_arg)]
            argtypes = tuple(getattr(mod, types_arg.id))
            out += [(path.name, lib, name, argtypes) for name in names]
    return out


def mismatches(entries: dict[str, list[str]], name: str, argtypes) -> list:
    if name not in entries:
        return [f"{name} is not declared inside extern \"C\""]
    params = entries[name]
    want = [_KIND.get(t, repr(t)) for t in argtypes]
    if len(params) != len(want):
        return [f"{name}: {len(params)} C parameters, {len(want)} argtypes"]
    return [f"{name} parameter {i}: C {p}, ctypes {w}"
            for i, (p, w) in enumerate(zip(params, want)) if p != w]


BINDINGS = bindings()


@pytest.mark.parametrize("wrapper,lib,name,argtypes", BINDINGS,
                         ids=[f"{b[1]}.{b[2]}" for b in BINDINGS])
def test_ctypes_signature_matches_c_entry(wrapper, lib, name, argtypes):
    entries = c_entry_points((KERNELS / "csrc" / f"{lib}.cu").read_text())
    assert mismatches(entries, name, argtypes) == [], wrapper


def test_every_c_entry_is_bound():
    """No C entry point is left without a wrapper that binds it."""
    bound = {(lib, name) for _, lib, name, _ in BINDINGS}
    for src in sorted((KERNELS / "csrc").glob("*.cu")):
        for name in c_entry_points(src.read_text()):
            assert (src.stem, name) in bound, f"{src.name}: {name} is unbound"


def test_checker_catches_arity_kind_and_missing_names():
    src = '''
    __global__ void k(int a) {}
    extern "C" {
    // int commented_out(int a) {
    int f(const void* x, int n, int64_t m, float a, void* stream) {
      if (n < 0) { return 1; }
      return 0;
    }
    }  // extern "C"
    int outside(int a) { return a; }
    '''
    entries = c_entry_points(src)
    assert entries == {"f": ["pointer", "int", "int64", "float", "pointer"]}
    p, i, i64, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_float)
    assert mismatches(entries, "f", (p, i, i64, f, p)) == []
    assert mismatches(entries, "f", (p, i, i64, f)) != []          # arity
    assert mismatches(entries, "f", (p, i, i, f, p)) != []         # int64 as int
    assert mismatches(entries, "f", (p, f, i64, i, p)) != []       # int/float
    assert mismatches(entries, "outside", (i,)) != []              # not extern C
