"""The ctypes signatures of falkordb_tpu_torch/native/cuda.py against the C
entry points of falkordb_tpu_torch/csrc/*.cu, on the CPU.

The kernels are built only on the card, and ctypes converts each argument
by the argtypes it is given: a 64-bit value declared as a 32-bit int, or an
entry point whose parameters changed while its argtypes did not, passes the
wrong bits with no error.  So every `FK_EXPORT` function must have an entry
in `_SIGNATURES` with one argtype a parameter, in order: a pointer as
c_void_p (or a ctypes pointer to the pointee's type, for the host outputs),
int64_t as c_int64, int32_t as c_int32, int as c_int, float as c_float; and
its return type must match the restype `lib()` gives it.
"""

import ctypes
import glob
import os
import re

import pytest

from falkordb_tpu_torch.native import cuda

_DECL = re.compile(r"FK_EXPORT\s+([\w\s\*]+?)\s*\b(fk_\w+)\s*\(([^)]*)\)", re.S)
_SCALARS = {"int64_t": ctypes.c_int64, "int32_t": ctypes.c_int32,
            "int": ctypes.c_int, "float": ctypes.c_float}


def _declarations():
    out = {}
    for path in sorted(glob.glob(os.path.join(cuda.CSRC, "*.cu"))):
        with open(path) as f:
            for ret, name, params in _DECL.findall(f.read()):
                types = []
                for p in params.split(","):
                    p = " ".join(p.split())
                    if p:
                        types.append(re.sub(r"\s*\b\w+$", "", p))
                out[name] = (" ".join(ret.split()), types,
                             os.path.basename(path))
    return out


DECLS = _declarations()


def _accepts(ctype, c_type):
    """Whether ctypes argtype `ctype` passes a C parameter of `c_type`."""
    if c_type.endswith("*"):
        if ctype is ctypes.c_void_p:
            return True
        pointee = c_type[:-1].replace("const", "").strip()
        return (isinstance(ctype, type) and issubclass(ctype, ctypes._Pointer)
                and pointee in _SCALARS
                and ctypes.sizeof(ctype._type_) == ctypes.sizeof(
                    _SCALARS[pointee]))
    return ctype is _SCALARS.get(c_type)


def test_every_entry_point_is_bound():
    names = set(DECLS) - {"fk_error_string"}
    assert names == set(cuda._SIGNATURES)
    assert set(cuda._RESTYPES) <= names


@pytest.mark.parametrize("name", sorted(cuda._SIGNATURES))
def test_argtypes_match_the_declaration(name):
    ret, params, source = DECLS[name]
    argtypes = cuda._SIGNATURES[name]
    assert len(argtypes) == len(params), (source, params)
    for i, (ctype, c_type) in enumerate(zip(argtypes, params)):
        assert _accepts(ctype, c_type), (source, i, c_type, ctype)
    restype = cuda._RESTYPES.get(name, ctypes.c_int)
    assert restype is _SCALARS[ret], (source, ret, restype)
