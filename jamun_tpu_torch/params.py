"""Parameter bridge between a flax param tree of a JAX arch (E3Conv,
Ophiuchus) and the port's `state_dict()` of the same arch.

The torch modules carry the flax names, so the mapping is the tree path
joined with "." (e.g. `_HiddenLayer_0/ConvBlock_0/Conv_0/radial_nn/Dense_1/
kernel` -> `_HiddenLayer_0.ConvBlock_0.Conv_0.radial_nn.Dense_1.kernel`).
Orientation is kept as flax has it: a Dense `kernel` is [in, out] and the
port's `ops.mlp.Dense` computes x @ kernel + bias; IrrepsLinear kernels
`w_i_j` are [mul_in, mul_out] on both sides. Nothing is transposed.

The same holds for every module of the equivariant-ops library:
`ExperimentalConv` / `Conv(tensor_product="experimental")` (its radial MLP
alone, `radial_nn/Dense_k/{kernel, bias}`: the external linear's weights
come from it, and there is no post-linear), `IrrepsLinear` with paths of
any l (`w_{i_in}_{i_out}` [mul_in, mul_out]),
`MultiheadAttention` (`IrrepsLinear_0` the queries, `_PerEdgeConv_0/1` the
keys and values, each a `radial_nn`, `dot_w` [weight_numel], `IrrepsLinear_1`),
`TransformerBlock` (`IrrepsLinear_0`-`_3`, `MultiheadAttention_0`,
`EquivariantMLP_0`), the wrappers of `ops/wrappers.py`, and EquiFold's
modules (`ops/contrib/equifold.py`): `SVLinear`'s `w_s` [out, in], `b_s`
[out], `w_v` [out, in]; per head (`DTPByHead`, Equiformer's `w_s_init`,
`attn_msg_w_s`, ...) [H, out, in] and [H, out]; `RadialNN`'s `Dense_k` as
flax's Dense ([in, out]). None of these is transposed either.

`E3Conv(scan_layers=True)` in JAX runs its hidden layers under `nn.scan`,
and flax keeps their parameters in one subtree, `Scan_HiddenLayer_0`, each
leaf with a leading axis of length `n_layers`. The port keeps its
`_HiddenLayer_k` modules either way: `from_jax_params` slices that subtree
into them (it knows the subtree by its name), and `to_jax_params(...,
scan_layers=True)` stacks them back; the model says whether it is scanned,
the shapes are not read for it.

`load_jax_train_state` places a whole JAX train state (as
`train.checkpoints.read_flax_msgpack` reads it) in the port's `TrainState`;
`init_parameters` draws a module's parameters from a seed (each submodule's
flax initializer, on a CPU generator).
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch

__all__ = [
    "from_jax_params", "to_jax_params", "load_jax_train_state", "init_parameters", "flax_names",
    "SCANNED",
]

_OTHER = "ROADMAP.md queue A, 'Other config targets'"


SCANNED = "Scan_HiddenLayer_0"  # flax's name of `nn.scan(_HiddenLayer, ...)`'s subtree
_LAYER = "_HiddenLayer_"


def _leaves(node: Mapping, prefix: str = ""):
    for k, v in node.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, Mapping):
            yield from _leaves(v, name)
        else:
            yield name, v


def from_jax_params(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (optionally under "params") -> a
    state_dict of f32 tensors for the arch's `load_state_dict(..., strict=True)`.
    A scanned E3Conv's `Scan_HiddenLayer_0` goes to `_HiddenLayer_k`, each
    leaf's slice k of its leading axis."""
    if set(tree.keys()) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}
    for name, v in _leaves(tree):
        a = np.array(v, dtype=np.float32)
        head, _, rest = name.partition(".")
        if head == SCANNED:
            for k in range(a.shape[0]):
                out[f"{_LAYER}{k}.{rest}"] = torch.from_numpy(a[k])
        else:
            out[name] = torch.from_numpy(a)
    return out


def to_jax_params(state_dict: Mapping[str, torch.Tensor], scan_layers: bool = False) -> dict:
    """The inverse: a state_dict -> {"params": nested dict of numpy arrays}.
    With `scan_layers=True` (the model's own flag) the `_HiddenLayer_k`
    modules go to one `Scan_HiddenLayer_0` subtree, each leaf stacked over k
    on a new leading axis, where flax keeps a scanned E3Conv's layers."""
    tree: dict = {}
    layers: Dict[int, Dict[str, np.ndarray]] = {}
    for name, t in state_dict.items():
        a = t.detach().cpu().numpy()
        head, _, rest = name.partition(".")
        if scan_layers and head.startswith(_LAYER):
            if not layers:
                tree[SCANNED] = {}  # flax's place for it: where the first layer was
            layers.setdefault(int(head[len(_LAYER):]), {})[rest] = a
            continue
        _put(tree, name, a)
    if scan_layers:
        if sorted(layers) != list(range(len(layers))) or not layers:
            raise ValueError(f"scan_layers: hidden layers {sorted(layers)} are not 0..n-1")
        for rest in layers[0]:
            _put(tree[SCANNED], rest, np.stack([layers[k][rest] for k in range(len(layers))]))
    return {"params": tree}


def _put(tree: dict, name: str, value) -> None:
    node = tree
    *path, leaf = name.split(".")
    for k in path:
        node = node.setdefault(k, {})
    node[leaf] = value


def init_parameters(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every submodule's `reset_parameters(generator)` (flax's init
    distributions) from one CPU generator seeded with `seed`, in module
    order; returns the module."""
    generator = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
    return module


def flax_names(names: List[str], scan_layers: bool) -> List[str]:
    """Each parameter's flax leaf, by name: as it is, except that a scanned
    model's `_HiddenLayer_k.<path>` is a slice of `Scan_HiddenLayer_0.<path>`
    (the slices of one leaf share its name)."""
    if not scan_layers:
        return list(names)
    out = []
    for name in names:
        head, _, rest = name.partition(".")
        out.append(f"{SCANNED}.{rest}" if head.startswith(_LAYER) else name)
    return out


def _tensor(value) -> torch.Tensor:
    """A leaf of a JAX tree (numpy, or a torch bf16 tensor from
    `read_flax_msgpack`) as a tensor of its own dtype."""
    return value if torch.is_tensor(value) else torch.from_numpy(np.array(value))


class _Walk:
    """`_load_jax_opt_state`'s walk: JAX's opt_state against the rule's
    declared layout (`optim._Node.jax_state_layout`), placing each value
    where its slot says, into the node whose tree it is (`optim._Scope`
    marks the tree of a rule inside a wrapper or combinator)."""

    def __init__(self, optimizer, module: torch.nn.Module):
        self.opt = self.node = optimizer
        self.params = dict(module.named_parameters())
        self.torch_names = {id(p): n for n, p in self.params.items()}
        self.counts: Dict[int, List[int]] = {}
        self.modded: Dict[int, list] = {}  # counts optax keeps modulo a period
        self.initial: Dict[int, List[bool]] = {}
        self.outer: List[int] = []

    def place(self, layout, tree, path: str) -> None:
        from jamun_tpu_torch.train import optim

        node = self.node
        if isinstance(layout, dict):
            if not isinstance(tree, Mapping) or set(tree) != set(layout):
                got = sorted(tree) if isinstance(tree, Mapping) else type(tree).__name__
                rule = getattr(node, "alias", type(node).__name__)
                raise ValueError(f"{path}: JAX's state has {got}, {rule} keeps {sorted(layout)}")
            for k in layout:
                self.place(layout[k], tree[k], f"{path}/{k}")
        elif isinstance(layout, optim._Scope):
            self.node = layout.node
            try:
                self.place(layout.layout, tree, path)
            finally:
                self.node = node
        elif isinstance(layout, optim._Count):
            if layout.outer:
                self.outer.append(int(np.asarray(tree)))
            elif layout.mod is not None:
                self.modded.setdefault(id(node), []).append((int(np.asarray(tree)), layout.mod))
            else:
                self.counts.setdefault(id(node), []).append(int(np.asarray(tree)))
        elif isinstance(layout, optim._Param):
            self.place_params(node, layout.key, tree, path)
        elif isinstance(layout, optim._Leaf):
            if isinstance(tree, Mapping) and set(tree.keys()) == {"params"}:
                tree = tree["params"]
            for leaf, name in enumerate(node.leaf_names()):
                sub = tree
                for k in name.split("."):
                    sub = sub[k]
                value = ({k: _tensor(v) for k, v in sub.items()} if isinstance(sub, Mapping)
                         else _tensor(sub))
                layout.place(node, leaf, value)
        elif isinstance(layout, optim._Custom):
            layout.place(node, _tensor(tree))
        elif isinstance(layout, optim._Group):
            value = _tensor(tree)
            dev = node.param_groups[0]["params"][0].device
            node.param_groups[0][layout.key] = value.to(dev) if layout.device else value.item()
        elif isinstance(layout, optim._Initial):
            self.initial.setdefault(id(node), []).append(bool(np.asarray(tree)))
        elif not isinstance(layout, optim._Unused):
            raise TypeError(f"{path}: unknown slot {layout!r}")

    def place_params(self, node, key: str, tree, path: str) -> None:
        """A tree of the parameters' shapes (left-out leaves empty, as flax
        writes optax's MaskedNode): each of `node`'s parameters its slice;
        a node over `flatten`'s one vector takes the array itself."""
        params = node.param_groups[0]["params"]
        if not any(id(p) in self.torch_names for p in params):
            if isinstance(tree, Mapping) or len(params) != 1:
                raise ValueError(f"{path}: want one flat array for {len(params)} parameters")
            node.state[params[0]][key] = _tensor(tree).to(params[0].device).clone()
            return
        leaves = {}
        if set(tree.keys()) == {"params"}:
            tree = tree["params"]
        for name, v in _leaves(tree):
            t = _tensor(v)
            head, _, rest = name.partition(".")
            if head == SCANNED:
                for k in range(t.shape[0]):
                    leaves[f"{_LAYER}{k}.{rest}"] = t[k]
            else:
                leaves[name] = t
        want = {self.torch_names[id(p)]: p for p in params}
        if sorted(leaves) != sorted(want):
            raise ValueError(f"{path}: leaves {sorted(set(leaves) ^ set(want))} differ from the "
                             "parameters")
        for name, p in want.items():
            node.state[p][key] = leaves[name].to(p.device).clone()

    def finish(self, step: int) -> None:
        """Each rule's count: every place optax keeps one must agree; with
        none, a chained schedule's count (the outermost rule), MultiSteps'
        gradient steps (its rule), the count of the node around it, or the
        train state's step."""
        from jamun_tpu_torch.train import optim

        def resolve(node, default: int) -> None:
            counts = self.counts.get(id(node), [])
            if len(set(counts)) > 1:
                raise ValueError(f"opt_state: the rule's counts {counts} differ")
            count = counts[0] if counts else default
            for value, mod in self.modded.get(id(node), []):
                if count % mod != value:
                    raise ValueError(f"opt_state: a count {value} modulo {mod} at count {count}")
            group = node.param_groups[0]
            if any(flag != (count == 0) for flag in self.initial.get(id(node), [])):
                raise ValueError(f"opt_state: is_initial_step {self.initial[id(node)]} at "
                                 f"count {count}")
            if isinstance(node, optim._OptaxRule) or counts:
                group["count"] = count
            for kid in node._kids():
                resolve(kid, group["gradient_step"] if isinstance(node, optim._MultiSteps)
                        else count)

        root = self.opt
        counts = self.counts.get(id(root), [])
        top = counts[0] if counts else (self.outer[0] if self.outer else step)
        if self.outer and isinstance(root, optim._OptaxRule) and self.outer[0] != top:
            raise NotImplementedError(
                f"opt_state's scale_by_schedule count {self.outer[0]} differs from the rule's "
                f"{top}; the port keeps one count for both ({_OTHER})")
        resolve(root, top)


def _load_jax_opt_state(opt_state: Mapping, module: torch.nn.Module, optimizer, step: int) -> None:
    """optax's state for any rule of `train/optim.py` (alone, chained with
    `model.lr_scheduler`'s `scale_by_schedule`, or inside wrappers and
    combinators): one walk over the rule's declaration of optax's tree
    (`jax_state_layout`), each value placed by its parameter's name or its
    flax leaf."""
    from jamun_tpu_torch.train import optim  # train/ imports this module

    if not isinstance(optimizer, optim._Node):
        raise NotImplementedError(
            f"JAX's optimizer state into {type(optimizer).__name__} is not ported ({_OTHER})"
        )
    named = list(module.named_parameters())
    if len(optimizer.param_groups) != 1 or [id(p) for p in optimizer.param_groups[0]["params"]] != [
        id(p) for _, p in named
    ]:
        raise ValueError("the optimizer must hold the module's parameters in one group")
    walk = _Walk(optimizer, module)
    for p in optimizer.param_groups[0]["params"]:
        optimizer.state[p] = {}
    walk.place(optimizer.jax_state_layout(), opt_state, "opt_state")
    walk.finish(step)


def load_jax_train_state(tree: Mapping, state):
    """JAX's `TrainState` {step, params, opt_state, ema_params, rng} into the
    port's `state` (in place; returned): `params` and `ema_params` into
    `state.module` and `state.ema` (strict), `step`, and `opt_state` into the
    optimizer (`_load_jax_opt_state`). A rule the port lacks, or a chained
    schedule it cannot place, raises rather than load a wrong state.

    A scanned E3Conv's trees (its layers stacked under
    `Scan_HiddenLayer_0`) load the same way: the parameters, the EMA and
    every elementwise state are sliced into the layers; a statistic of a
    whole flax leaf (adafactor's factors, novograd's nu, sm3's
    accumulators) stays whole on the leaf's first parameter.

    `rng` (a JAX PRNG key) is not carried: the port draws its noise from
    `torch.Generator`s, which a JAX key cannot seed to the same stream, so
    `state.generator` and `state.host_generator` keep their seeds."""
    missing = {"step", "params", "opt_state", "ema_params"} - set(tree)
    if missing:
        raise KeyError(f"not a JAX train state: {sorted(missing)} missing")
    step = int(np.asarray(tree["step"]))
    state.module.load_state_dict(from_jax_params(tree["params"]), strict=True)
    state.ema.load_state_dict(from_jax_params(tree["ema_params"]), strict=True)
    _load_jax_opt_state(tree["opt_state"], state.module, state.optimizer, step)
    state.step = step
    return state
