"""Structured box fast path.

Macro aggregation: a box-structured Kuhn-tetrahedral mesh
(the reference's ``MeshInfo::meshCuboid`` + ``meshSymmetricCuboid``
family, reference: src/hyteg/mesh/MeshInfo.hpp) is stored as ONE dense
node grid per domain instead of one padded block per macro-tet.  This
layout has zero interface duplication, no halo exchange on one card, 6x
the DoF density of per-tet blocks, and a translation-invariant 15-point
stencil whose boundary corrections collapse into static per-lane weight
vectors (see kuhn.py).
"""

from .box import BoxDomain
from .operator import BoxStencilOperator
