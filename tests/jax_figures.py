"""The JAX package's figures that test files keep as Python literals, so a
test need not trace and compile the JAX side on every run: each figure is
``(shape, flat values)``, and a file's ``python tests/<file>.py`` prints
them anew with ``print_figures``."""

import numpy as np


def stored(figures):
    """``{name: (shape, flat values)}`` (or a dict of such dicts) -> arrays."""
    return {k: (stored(v) if isinstance(v, dict)
                else np.asarray(v[1], dtype=np.float64).reshape(v[0]))
            for k, v in figures.items()}


def _lines(name, figures, indent):
    out = [f"{indent}{name}: {{" if indent else f"{name} = {{"]
    inner = indent + "    "
    for k, v in figures.items():
        if isinstance(v, dict):
            out += _lines(repr(k), v, inner)
            continue
        a = np.asarray(v, dtype=np.float64)
        vals = [repr(float(x)) for x in a.reshape(-1)]
        out.append(f"{inner}{k!r}: ({tuple(a.shape)}, [")
        line = ""
        for piece in (x + "," for x in vals):
            if line and len(inner) + 4 + len(line) + 1 + len(piece) > 99:
                out.append(inner + "    " + line)
                line = ""
            line = f"{line} {piece}" if line else piece
        if line:
            out.append(inner + "    " + line)
        out.append(f"{inner}]),")
    out.append(f"{indent}}}," if indent else "}")
    return out


def print_figures(name, figures):
    """``name = {...}`` in the layout ``stored`` reads, every value printed
    to round-trip: ``figures`` maps names to arrays, or to dicts of them."""
    print("\n".join(_lines(name, figures, "")))
