"""The ctypes argument types of the kernel library (``kernels/build.py``
SIGNATURES) against the C entry points of ``kernels/csrc/*.cu``.

ctypes passes an argument as the type it is told: a pointer declared as an
int is cut to 32 bits, a float declared as an int arrives as garbage.  The
sources do not compile here, so their ``extern "C"`` declarations are read
as text: each parameter is a pointer (``*``), a ``float`` or an ``int``."""
import ctypes
import re

import pytest

from repro_torch.kernels import build

_KIND = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
         ctypes.c_float: "float"}


def _entry_points():
    """{name: (source file name, [parameter kinds])} of every function
    declared in an ``extern "C"`` block of the sources."""
    found = {}
    for src in sorted(build.CSRC.glob("*.cu")):
        text = src.read_text()
        for block in re.findall(r'extern "C" \{(.*?)\n\}  // extern "C"',
                                text, re.S):
            for name, params in re.findall(r"\bint (\w+)\(([^)]*)\)\s*\{",
                                           block):
                kinds = []
                for p in params.split(","):
                    p = " ".join(p.split())
                    kinds.append("pointer" if "*" in p else
                                 "float" if p.startswith("float ") else
                                 "int" if p.startswith("int ") else p)
                found[name] = (src.name, kinds)
    return found


def test_every_entry_point_has_a_signature():
    assert set(_entry_points()) == set(build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_signature_matches_the_declaration(name):
    src, kinds = _entry_points()[name]
    want = [_KIND[t] for t in build.SIGNATURES[name]]
    assert kinds == want, f"{name} in {src}"
