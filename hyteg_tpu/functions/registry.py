"""Function registry and block functions (type-erased composition).

Reference: src/hyteg/functions/FEFunctionRegistry.hpp:50 (per-space
function stores queried by name/kind, used by VTK output and checkpoint
to enumerate everything attached to a storage) and
src/hyteg/functions/BlockFunction.hpp:39 (a vector of type-erased
sub-functions with joint assign/dot/enumerate — the base of the Stokes
block functions).

Redesign: functions here are pytrees, so the "type erasure"
is structural — a BlockFunction is itself a pytree of its components
with vector-space arithmetic, and the registry stores (name -> kind,
object) pairs for enumeration by IO/checkpoint code.  No virtual
dispatch is needed; everything stays jit-compatible.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable

import jax
import jax.numpy as jnp


class FEFunctionRegistry:
    """Name -> (kind, function) store with by-kind queries.

    ``kind`` is a free-form space tag ("P1", "P2", "P1Vector", "P0",
    "DG", "N1E1", "EG", ...); the reference keeps one typed store per
    space — a single dict keyed by tag does the same job here."""

    def __init__(self):
        self._by_name: dict[str, tuple[str, Any]] = {}

    def add(self, name: str, kind: str, fn: Any) -> None:
        if name in self._by_name:
            raise ValueError(f"function {name!r} already registered")
        self._by_name[name] = (kind, fn)

    def remove(self, name: str) -> None:
        self._by_name.pop(name, None)

    def get(self, name: str) -> Any:
        return self._by_name[name][1]

    def kind(self, name: str) -> str:
        return self._by_name[name][0]

    def names(self, kind: str | None = None) -> list[str]:
        """All registered names, optionally restricted to one space kind
        (reference: getFunctionNames / forEachFunctionOfType)."""
        return [n for n, (k, _) in self._by_name.items()
                if kind is None or k == kind]

    def items(self, kind: str | None = None) -> Iterable[tuple[str, Any]]:
        for n, (k, f) in self._by_name.items():
            if kind is None or k == kind:
                yield n, f

    def __len__(self) -> int:
        return len(self._by_name)

    def __contains__(self, name: str) -> bool:
        return name in self._by_name


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class BlockFunction:
    """A tuple of component functions with joint vector-space ops.

    Components may be raw arrays or any pytree supporting + / - /
    scalar * (P1Function, EGFunction, nested BlockFunction, ...).
    ``dots`` optionally carries one dot callable per component for
    ``dot``; without it, a flat elementwise dot over all leaves is used
    (reference: BlockFunction::dotGlobal, BlockFunction.hpp:225)."""

    comps: tuple
    dots: tuple = dataclasses.field(default=(), metadata=dict(static=True))

    def tree_flatten(self):
        return (self.comps,), (self.dots,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0])

    def __len__(self):
        return len(self.comps)

    def __getitem__(self, idx):
        return self.comps[idx]

    def __add__(self, o):
        return BlockFunction(
            tuple(a + b for a, b in zip(self.comps, o.comps)), self.dots)

    def __sub__(self, o):
        return BlockFunction(
            tuple(a - b for a, b in zip(self.comps, o.comps)), self.dots)

    def __mul__(self, s):
        return BlockFunction(tuple(s * c for c in self.comps), self.dots)

    __rmul__ = __mul__

    def dot(self, o: "BlockFunction") -> jnp.ndarray:
        if self.dots:
            acc = jnp.asarray(0.0)
            for d, a, b in zip(self.dots, self.comps, o.comps):
                acc = acc + d(a, b)
            return acc
        acc = jnp.asarray(0.0)
        for a, b in zip(jax.tree.leaves(self.comps),
                        jax.tree.leaves(o.comps)):
            acc = acc + jnp.sum(a * b)
        return acc

    def norm(self) -> jnp.ndarray:
        return jnp.sqrt(self.dot(self))

    def zeros_like(self) -> "BlockFunction":
        return BlockFunction(
            jax.tree.map(jnp.zeros_like, self.comps), self.dots)
