"""Runtime-editable CSG node graph: a copy of `raymarch_tpu.models.graph`.

The programmatic equivalent of the reference's visual node-graph editor
(reference src/csg_node_graph.rs): a mutable graph of typed nodes
(primitive/operator templates with scalar, vec3, and SDF-connection inputs)
that is *evaluated* into the immutable CSG expression tree
(`raymarch_tpu_torch.models.csg`) on demand. Parity points:

- Templates with named, typed inputs; constants inline, SDF inputs by
  connection only (reference DataType/ValueType, csg_node_graph.rs:18-22,
  and ConnectionOnly SDF inputs, operations/mod.rs:43-50).
- A distinguished Root node with a single SDF input
  (csg_node_graph.rs:130-139); `evaluate_root()` follows it.
- Pull-based, memoized evaluation: shared subgraphs evaluate once per call
  (per-output cache, csg_node_graph.rs:266,284-289).
- Failure semantics: a node with a missing required connection evaluates to
  None, which propagates to the root; the renderer then receives an empty
  tape and draws background/floor only, never an exception
  (csg_node_graph.rs evaluate -> None; wgsl:188-191).

The graph is the "editor state"; `evaluate_root()` + `compile_wire`/
`compile_scene` is the per-frame path (reference main.rs:75 -> renderer
prepare). Compiled tapes are bucketed, so repeated edit -> evaluate ->
compile cycles keep one `TapeSpec` and reuse one renderer. Pure Python over
the port's numpy scene model; tests/test_torch_tape.py guards the copy
against drift (equal `to_dict` snapshots and compiled tapes).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, Optional, Tuple

from ..utils import math3d
from . import csg

# ---------------------------------------------------------------------------
# Templates
# ---------------------------------------------------------------------------

SCALAR = "scalar"
VEC3 = "vec3"
SDF = "sdf"  # connection-only


@dataclasses.dataclass(frozen=True)
class InputSpec:
    name: str
    kind: str  # SCALAR | VEC3 | SDF
    default: Any = None


@dataclasses.dataclass(frozen=True)
class NodeTemplate:
    """A node type: named inputs + an evaluate function mapping resolved
    input values (None for missing SDF connections) to a CSGNode or None."""

    name: str
    inputs: Tuple[InputSpec, ...]
    evaluate: Callable[[Dict[str, Any]], Optional[csg.CSGNode]]


def _prim_eval(ctor):
    def ev(vals):
        return ctor(vals)

    return ev


def _binary_eval(ctor):
    def ev(vals):
        a, b = vals["A"], vals["B"]
        if a is None or b is None:  # missing operand => None (reference
            return None  # operations/mod.rs:47-48)
        return ctor(a, b, vals)

    return ev


TEMPLATES: Dict[str, NodeTemplate] = {}


def _register(name, inputs, evaluate):
    TEMPLATES[name] = NodeTemplate(name, tuple(inputs), evaluate)


_register(
    "Root",
    [InputSpec("SDF", SDF)],
    lambda vals: vals["SDF"],
)
_register(
    "Sphere",
    [InputSpec("center", VEC3, (0.0, 0.0, 0.0)), InputSpec("radius", SCALAR, 1.0)],
    _prim_eval(lambda v: csg.sphere(v["center"], v["radius"])),
)
_register(
    "Box",
    [
        InputSpec("center", VEC3, (0.0, 0.0, 0.0)),
        InputSpec("half_extents", VEC3, (1.0, 1.0, 1.0)),
    ],
    _prim_eval(lambda v: csg.box(v["center"], v["half_extents"])),
)
_register(
    "Torus",
    [
        InputSpec("center", VEC3, (0.0, 0.0, 0.0)),
        InputSpec("major_radius", SCALAR, 1.0),
        InputSpec("minor_radius", SCALAR, 0.25),
    ],
    _prim_eval(lambda v: csg.torus(v["center"], v["major_radius"], v["minor_radius"])),
)
_register(
    "Plane",
    [InputSpec("normal", VEC3, (0.0, 1.0, 0.0)), InputSpec("offset", SCALAR, 0.0)],
    _prim_eval(lambda v: csg.plane(v["normal"], v["offset"])),
)
_register(
    "Cylinder",
    [
        InputSpec("center", VEC3, (0.0, 0.0, 0.0)),
        InputSpec("radius", SCALAR, 0.5),
        InputSpec("half_height", SCALAR, 1.0),
    ],
    _prim_eval(lambda v: csg.cylinder(v["center"], v["radius"], v["half_height"])),
)
_register(
    "Capsule",
    [
        InputSpec("center", VEC3, (0.0, 0.0, 0.0)),
        InputSpec("radius", SCALAR, 0.5),
        InputSpec("half_height", SCALAR, 1.0),
    ],
    _prim_eval(lambda v: csg.capsule(v["center"], v["radius"], v["half_height"])),
)
_register(
    "Cone",
    [
        InputSpec("center", VEC3, (0.0, 0.0, 0.0)),
        InputSpec("half_height", SCALAR, 1.0),
        InputSpec("r_bottom", SCALAR, 0.5),
        InputSpec("r_top", SCALAR, 0.0),
    ],
    _prim_eval(
        lambda v: csg.cone(v["center"], v["half_height"], v["r_bottom"], v["r_top"])
    ),
)
_register(
    "Material",
    [InputSpec("A", SDF), InputSpec("albedo", VEC3, (0.5, 0.5, 0.5))],
    lambda vals: None
    if vals["A"] is None
    else vals["A"].paint(tuple(vals["albedo"]), overwrite=True),
)
_register(
    "Union",
    [InputSpec("A", SDF), InputSpec("B", SDF)],
    _binary_eval(lambda a, b, v: csg.Union(a, b)),
)
_register(
    "Subtraction",
    [InputSpec("A", SDF), InputSpec("B", SDF)],
    _binary_eval(lambda a, b, v: csg.Subtraction(a, b)),
)
_register(
    "Intersection",
    [InputSpec("A", SDF), InputSpec("B", SDF)],
    _binary_eval(lambda a, b, v: csg.Intersection(a, b)),
)
for _name, _ctor in [
    ("SmoothUnion", csg.SmoothUnion),
    ("SmoothSubtraction", csg.SmoothSubtraction),
    ("SmoothIntersection", csg.SmoothIntersection),
]:
    _register(
        _name,
        [InputSpec("A", SDF), InputSpec("B", SDF), InputSpec("k", SCALAR, 0.25)],
        _binary_eval(lambda a, b, v, c=_ctor: c(a, b, float(v["k"]))),
    )
_register(
    "Round",
    [InputSpec("A", SDF), InputSpec("radius", SCALAR, 0.1)],
    lambda vals: None
    if vals["A"] is None
    else csg.Round(vals["A"], float(vals["radius"])),
)
_register(
    "Onion",
    [InputSpec("A", SDF), InputSpec("thickness", SCALAR, 0.1)],
    lambda vals: None
    if vals["A"] is None
    else csg.Onion(vals["A"], float(vals["thickness"])),
)
_register(
    "Translate",
    [InputSpec("A", SDF), InputSpec("offset", VEC3, (0.0, 0.0, 0.0))],
    lambda vals: None
    if vals["A"] is None
    else csg.Translate(vals["A"], tuple(vals["offset"])),
)
_register(
    "Rotate",
    [InputSpec("A", SDF), InputSpec("quat", VEC3, None), InputSpec("axis", VEC3, (0, 1, 0)), InputSpec("angle", SCALAR, 0.0)],
    lambda vals: None
    if vals["A"] is None
    else csg.Rotate(
        vals["A"],
        tuple(math3d.quat_normalize(vals["quat"]))
        if vals["quat"] is not None
        else tuple(math3d.quat_from_axis_angle(vals["axis"], float(vals["angle"]))),
    ),
)
_register(
    "Scale",
    [InputSpec("A", SDF), InputSpec("factor", SCALAR, 1.0)],
    lambda vals: None if vals["A"] is None else csg.Scale(vals["A"], float(vals["factor"])),
)


def all_templates() -> Tuple[str, ...]:
    """Template names (reference CSGNodeTemplate::all, csg/mod.rs:57-64)."""
    return tuple(TEMPLATES)


# ---------------------------------------------------------------------------
# Graph
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Node:
    id: int
    template: str
    # input name -> constant value (scalar/tuple) or ("node", other_id).
    inputs: Dict[str, Any] = dataclasses.field(default_factory=dict)


class CSGNodeGraph:
    """Mutable node graph with reference-editor semantics."""

    def __init__(self) -> None:
        self._ids = itertools.count()
        self.nodes: Dict[int, Node] = {}

    # -- editing --------------------------------------------------------
    def add_node(self, template: str, **inputs) -> int:
        if template not in TEMPLATES:
            raise KeyError(f"unknown template {template!r}; see all_templates()")
        nid = next(self._ids)
        node = Node(nid, template)
        self.nodes[nid] = node
        for name, value in inputs.items():
            self.set_input(nid, name, value)
        return nid

    def remove_node(self, node_id: int) -> None:
        self.nodes.pop(node_id)
        for n in self.nodes.values():  # drop dangling connections
            for k, v in list(n.inputs.items()):
                if isinstance(v, tuple) and len(v) == 2 and v[0] == "node" and v[1] == node_id:
                    del n.inputs[k]

    def _input_spec(self, node: Node, name: str) -> InputSpec:
        for spec in TEMPLATES[node.template].inputs:
            if spec.name == name:
                return spec
        raise KeyError(f"{node.template} has no input {name!r}")

    def set_input(self, node_id: int, name: str, value: Any) -> None:
        """Set a constant input value (scalars/vec3s only)."""
        node = self.nodes[node_id]
        spec = self._input_spec(node, name)
        if spec.kind == SDF:
            raise TypeError(
                f"{node.template}.{name} is an SDF input: connect() it "
                "(ConnectionOnly in the reference)"
            )
        node.inputs[name] = value

    def connect(self, src_id: int, dst_id: int, dst_input: str) -> None:
        dst = self.nodes[dst_id]
        self._input_spec(dst, dst_input)  # validates the name
        if src_id not in self.nodes:
            raise KeyError(f"no node {src_id}")
        dst.inputs[dst_input] = ("node", src_id)

    def disconnect(self, dst_id: int, dst_input: str) -> None:
        self.nodes[dst_id].inputs.pop(dst_input, None)

    def add_root(self) -> int:
        return self.add_node("Root")

    # -- evaluation (reference csg_node_graph.rs:251-309) ---------------
    def evaluate_root(self) -> Optional[csg.CSGNode]:
        """Find the Root node and fold the graph beneath it into a typed
        CSG tree. Returns None for empty/incomplete graphs (the renderer
        then draws background only; nothing ever raises for missing
        connections)."""
        root = next(
            (n for n in self.nodes.values() if n.template == "Root"), None
        )
        if root is None:
            return None
        cache: Dict[int, Optional[csg.CSGNode]] = {}
        return self._evaluate_node(root, cache, frozenset())

    def _evaluate_node(self, node: Node, cache, visiting) -> Optional[csg.CSGNode]:
        if node.id in cache:
            return cache[node.id]
        if node.id in visiting:
            raise ValueError(f"cycle through node {node.id} ({node.template})")
        visiting = visiting | {node.id}

        vals: Dict[str, Any] = {}
        for spec in TEMPLATES[node.template].inputs:
            raw = node.inputs.get(spec.name, None)
            if isinstance(raw, tuple) and len(raw) == 2 and raw[0] == "node":
                src = self.nodes.get(raw[1])
                vals[spec.name] = (
                    self._evaluate_node(src, cache, visiting) if src else None
                )
            elif raw is None:
                vals[spec.name] = spec.default if spec.kind != SDF else None
            else:
                vals[spec.name] = raw

        try:
            result = TEMPLATES[node.template].evaluate(vals)
        except (TypeError, ValueError):
            result = None  # malformed constants degrade like missing inputs
        cache[node.id] = result
        return result

    # -- serialization ----------------------------------------------------
    # The reference keeps its editor state only in memory
    # (src/csg_node_graph.rs:233-239, GraphEditorState); here the graph is a
    # plain JSON-able dict so editor sessions checkpoint/restore and travel
    # over the viewer's HTTP API.

    def to_dict(self) -> Dict[str, Any]:
        """JSON-able snapshot: node connections become {"$node": id}."""
        nodes = []
        for n in self.nodes.values():
            inputs = {}
            for k, v in n.inputs.items():
                if isinstance(v, tuple) and len(v) == 2 and v[0] == "node":
                    inputs[k] = {"$node": v[1]}
                elif isinstance(v, tuple):
                    inputs[k] = list(v)
                else:
                    inputs[k] = v
            nodes.append({"id": n.id, "template": n.template, "inputs": inputs})
        return {"nodes": nodes}

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "CSGNodeGraph":
        """Inverse of to_dict. Node ids are preserved; the id counter resumes
        past the largest id so later add_node calls never collide."""
        g = cls()
        max_id = -1
        for nd in data.get("nodes", ()):
            nid = int(nd["id"])
            if nd["template"] not in TEMPLATES:
                raise KeyError(f"unknown template {nd['template']!r}")
            if nid in g.nodes:
                raise ValueError(f"duplicate node id {nid}")
            g.nodes[nid] = Node(nid, nd["template"])
            max_id = max(max_id, nid)
        g._ids = itertools.count(max_id + 1)
        for nd in data.get("nodes", ()):
            node = g.nodes[int(nd["id"])]
            for k, v in nd.get("inputs", {}).items():
                spec = g._input_spec(node, k)  # validates the input name
                if isinstance(v, dict) and "$node" in v:
                    src = int(v["$node"])
                    if src not in g.nodes:
                        raise KeyError(f"connection to missing node {src}")
                    node.inputs[k] = ("node", src)
                else:
                    if spec.kind == SDF:
                        raise TypeError(
                            f"{node.template}.{k} is an SDF input: must be "
                            '{"$node": id}'
                        )
                    node.inputs[k] = tuple(v) if isinstance(v, list) else v
        return g
