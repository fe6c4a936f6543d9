"""The port's public surface against the JAX package's, read from both
source trees with ``ast`` (neither package is imported, so this runs in
a second).

For every module of ``rlpyt_tpu/`` outside ``ops/pallas/`` (whose
kernels live in the port's ``ops/frame_gather.py``, ``ops/lstm.py`` and
``ops/union_gather.py``), each public top-level class and function, each
public method of such a class, and each constructor argument (or flax /
dataclass / NamedTuple field) must have a same-named counterpart in the
port's module of the same path, or an entry in ``ALLOWED`` below.  A
method may be met by a method, property or ``self.<name>`` attribute of
the port's class or of a base class it names; an argument by the port
constructor's arguments (and its base's, where it passes ``*args`` or
``**kwargs`` on) or by a field.  Each entry of ``ALLOWED`` gives its
reason and a ``file:line``, and must still name something missing.  The
``__init__`` cases hold the package re-exports.
"""
import ast
import fnmatch
import re
from functools import lru_cache
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX, PORT = ROOT / "rlpyt_tpu", ROOT / "rlpyt_tpu_torch"

# Differences by design: what the port has in place of each JAX name.
# Keys are "<module path>:<Name>", "<module path>:<Class>.<method>" or
# "<module path>:<Class>(<argument>=)"; fnmatch patterns are allowed.
ALLOWED = {
    # Functional JAX state, which the port keeps in objects.
    "agents/base.py:StepCtx": (
        "traced schedule context of the jitted agent step; the port's "
        "agents take cum_steps and is_eval as arguments",
        "rlpyt_tpu_torch/agents/base.py:62"),
    "agents/*.py:*.init": (
        "flax makes a parameter tree apart from the module from a key; a "
        "torch module holds its parameters, made in initialize",
        "rlpyt_tpu_torch/agents/base.py:39"),
    "agents/*.py:*.example_agent_info": (
        "agent_info schema to preallocate the jitted collector's buffers; "
        "the port's Collector allocates them from the first step",
        "rlpyt_tpu_torch/samplers/rollout.py:177"),
    "algos/dqn.py:DqnTrainState": (
        "immutable train state threaded through jit; the port's algorithm "
        "holds it (state_attrs, what state_dict() saves)",
        "rlpyt_tpu_torch/algos/dqn.py:39"),
    "algos/pg.py:PgTrainState": (
        "immutable train state threaded through jit; the port's algorithm "
        "holds its model and optimizer", "rlpyt_tpu_torch/algos/pg.py:44"),
    "algos/qpg.py:QpgTrainState": (
        "immutable train state threaded through jit; the port's algorithm "
        "holds it (state_attrs)", "rlpyt_tpu_torch/algos/qpg.py:68"),
    "replay/base.py:ReplayState": (
        "immutable replay state threaded through jit; the port's buffer "
        "holds its ring and cursors", "rlpyt_tpu_torch/replay/base.py:76"),
    "replay/prioritized.py:PrioritizedReplayState": (
        "immutable replay state; the port's buffer holds its sum tree",
        "rlpyt_tpu_torch/replay/prioritized.py:48"),
    "replay/sequence.py:SequenceReplayState": (
        "immutable replay state; the port's buffer holds ring, rnn states "
        "and priorities", "rlpyt_tpu_torch/replay/sequence.py:51"),
    "runners/train.py:TrainCarry": (
        "the jitted runner's carry; the port's runners return "
        "state_dict() in its place", "rlpyt_tpu_torch/runners/train.py:150"),
    "samplers/rollout.py:RolloutState(key=)": (
        "a jax.random key; the port draws from a torch.Generator passed "
        "to collect", "rlpyt_tpu_torch/samplers/rollout.py:167"),
    "algos/base.py:RlAlgorithm(bootstrap_value=)": (
        "a class flag set (algos/base.py:44, algos/pg.py:48) and read "
        "nowhere in the JAX package; the port's PG computes its bootstrap "
        "value in optimize", "rlpyt_tpu_torch/algos/pg.py:170"),
    # JAX pure-functional envs: one env as a function of (key, state,
    # action, params), vmapped; the port writes envs on batched tensors.
    "envs/*.py:*.reset": (
        "single-env pure function vmapped by reset_batch; the port writes "
        "reset_batch on [B] tensors directly",
        "rlpyt_tpu_torch/envs/base.py:50"),
    "envs/*.py:*.step": (
        "single-env pure function vmapped by step_batch; the port writes "
        "step_batch on [B] tensors directly",
        "rlpyt_tpu_torch/envs/base.py:55"),
    "envs/*.py:*.example_info": (
        "env info schema to preallocate the jitted collector's buffers; "
        "the port's Collector allocates them from the first step",
        "rlpyt_tpu_torch/samplers/rollout.py:177"),
    "envs/base.py:Env.default_params": (
        "params pytree to vmap over; every JAX env returns None, and the "
        "port's envs hold their constants as attributes",
        "rlpyt_tpu/envs/base.py:51"),
    "runners/train.py:MinibatchRl(env_params=)": (
        "env params pytree passed to the pure env functions; no JAX env "
        "defines params (envs/base.py:51)", "rlpyt_tpu/runners/train.py:58"),
    "samplers/rollout.py:Collector(env_params=)": (
        "env params pytree passed to the pure env functions; no JAX env "
        "defines params (envs/base.py:51)",
        "rlpyt_tpu/samplers/rollout.py:111"),
    # TPU layouts and kernel switches (XLA:TPU and Pallas).
    "models/conv.py:BatchMinorConv": (
        "batch-minor conv layout for XLA:TPU's conv emitters; the port's "
        "trunk is plain NCHW", "rlpyt_tpu_torch/models/conv.py:1"),
    "models/mlp.py:BatchMinorInDense": (
        "dense layer reading the batch-minor trunk; the port's trunk is "
        "plain NCHW", "rlpyt_tpu_torch/models/mlp.py:1"),
    "models/*.py:*(space_to_depth=)": (
        "space-to-depth first conv for the MXU; the port runs the plain "
        "strided conv it equals (params.py re-blocks the weights)",
        "rlpyt_tpu_torch/params.py:80"),
    "models/conv.py:Conv2dModel(pre_blocked=)": (
        "input already in the blocked batch-minor layout of the TPU "
        "replay path", "rlpyt_tpu/models/conv.py:101"),
    "models/conv.py:Conv2dModel(batch_minor_out=)": (
        "batch-minor output for BatchMinorInDense",
        "rlpyt_tpu/models/conv.py:108"),
    "models/*.py:*(batch_minor_input=)": (
        "batch-minor input from the s2d trunk",
        "rlpyt_tpu/models/mlp.py:47"),
    "models/*.py:*(lstm_impl=)": (
        "picks lax.scan or the Pallas LSTM; the port always runs its "
        "CUDA kernels (K3a/K3/K4) or their plain versions on the CPU",
        "rlpyt_tpu_torch/ops/lstm.py:415"),
    "models/rnn.py:LstmCore(impl=)": (
        "picks lax.scan or the Pallas LSTM; the port always runs its "
        "CUDA kernels or their plain versions on the CPU",
        "rlpyt_tpu_torch/ops/lstm.py:415"),
    "algos/dqn.py:DQN(blocked_frame_sampling=)": (
        "samples frames in the blocked space-to-depth layout of the TPU "
        "trunk", "rlpyt_tpu/algos/dqn.py:41"),
    "algos/dqn.py:DQN(window_gather_kernel=)": (
        "picks a Pallas window gather; the port's frame replay always "
        "launches csrc/frame_gather.cu on the card",
        "rlpyt_tpu_torch/ops/frame_gather.py:80"),
    "algos/dqn.py:DQN(pallas_frame_gather=)": (
        "picks the Pallas frame gather; the port's frame replay always "
        "launches csrc/frame_gather.cu on the card",
        "rlpyt_tpu_torch/ops/frame_gather.py:80"),
    "replay/frame.py:*(blocked_s2d=)": (
        "stores frames in the blocked space-to-depth layout of the TPU "
        "trunk", "rlpyt_tpu/replay/frame.py:28"),
    "replay/frame.py:*(window_kernel=)": (
        "picks a Pallas window gather; the port always launches "
        "csrc/frame_gather.cu on the card",
        "rlpyt_tpu_torch/ops/frame_gather.py:80"),
    # GSPMD: one program over a jax.sharding mesh.  The port runs one
    # process a rank over torch.distributed (runners/sync.py).
    "parallel/mesh.py:replicated": (
        "a NamedSharding; the port's ranks each hold whole weights",
        "rlpyt_tpu_torch/parallel/mesh.py:126"),
    "parallel/mesh.py:batch_sharding": (
        "a NamedSharding; each port rank owns its lanes (DpShard)",
        "rlpyt_tpu_torch/parallel/mesh.py:126"),
    "parallel/mesh.py:shard_batch_tree": (
        "device_put onto a NamedSharding; each port rank owns its lanes",
        "rlpyt_tpu_torch/parallel/mesh.py:126"),
    "parallel/mesh.py:rollout_sharding": (
        "a NamedSharding; each port rank owns its lanes",
        "rlpyt_tpu_torch/parallel/mesh.py:126"),
    "parallel/mesh.py:replay_sharding": (
        "a NamedSharding; each port rank owns its lanes of every ring",
        "rlpyt_tpu_torch/parallel/mesh.py:126"),
    "parallel/mesh.py:carry_sharding": (
        "a NamedSharding of the jitted carry; the port has no carry",
        "rlpyt_tpu_torch/parallel/mesh.py:126"),
    "parallel/mesh.py:put_global": (
        "assembles a global jax.Array from per-host shards; each port "
        "rank keeps its own tensors", "rlpyt_tpu_torch/parallel/mesh.py:126"),
    "models/running_norm.py:RunningMeanStd(axis_name=)": (
        "names a mapped axis for jax.lax.pmean; no JAX caller sets it, "
        "and the port's ranks reduce over torch.distributed",
        "rlpyt_tpu/models/running_norm.py:17"),
    # JAX pytree helpers for immutable arrays.
    "struct.py:dataclass": (
        "registers a frozen dataclass as a JAX pytree; the port's trees "
        "are NamedTuples and dicts", "rlpyt_tpu_torch/struct.py:14"),
    "struct.py:field": (
        "pytree_node metadata of struct.dataclass",
        "rlpyt_tpu/struct.py:61"),
    "struct.py:tree_set": (
        "functional x.at[idx].set for immutable arrays; torch writes in "
        "place", "rlpyt_tpu/struct.py:80"),
    "struct.py:tree_dynamic_set": (
        "functional dynamic_update_slice for immutable arrays; torch "
        "writes in place", "rlpyt_tpu/struct.py:85"),
    # Arguments stored and never read in the JAX package.
    "algos/pg.py:PPO(value_clip=)": (
        "stored (pg.py:206) and never read", "rlpyt_tpu/algos/pg.py:194"),
    "agents/base.py:BaseAgent(initial_params=)": (
        "stored (base.py:51) and never read", "rlpyt_tpu/agents/base.py:48"),
    "distributions/epsilon_greedy.py:*EpsilonGreedy(dim=)": (
        "stored (epsilon_greedy.py:17) and never read",
        "rlpyt_tpu/distributions/epsilon_greedy.py:16"),
    "replay/uniform.py:UniformReplayBuffer.update_priorities": (
        "a no-op that returns the state; the port's algorithms update "
        "priorities only on a prioritized buffer",
        "rlpyt_tpu_torch/algos/dqn.py:169"),
}

@lru_cache(maxsize=None)
def parse(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), str(path))


def jax_modules():
    return sorted(p.relative_to(JAX).as_posix() for p in JAX.rglob("*.py")
                  if p.relative_to(JAX).parts[:2] != ("ops", "pallas"))


def public(name: str) -> bool:
    return not name.startswith("_")


def base_name(node: ast.expr):
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Subscript):    # Generic[T]
        return base_name(node.value)
    return None


@lru_cache(maxsize=None)
def class_index(pkg: Path) -> dict:
    """Class name -> [(module path, ClassDef)] over a package."""
    out = {}
    for p in sorted(pkg.rglob("*.py")):
        for node in parse(p).body:
            if isinstance(node, ast.ClassDef):
                out.setdefault(node.name, []).append(
                    (p.relative_to(pkg).as_posix(), node))
    return out


def find_class(pkg: Path, name: str, near: str):
    found = class_index(pkg).get(name, [])
    for rel, node in found:
        if rel == near:
            return rel, node
    return found[0] if found else (None, None)


def bases(pkg: Path, rel: str, cls: ast.ClassDef):
    for b in cls.bases:
        name = base_name(b)
        if name and name != cls.name:
            brel, node = find_class(pkg, name, rel)
            if node is not None:
                yield brel, node


def own_members(cls: ast.ClassDef) -> set:
    """Methods, properties, class attributes and ``self.x`` attributes."""
    out = set()
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Attribute)
                        and isinstance(sub.ctx, ast.Store)
                        and isinstance(sub.value, ast.Name)
                        and sub.value.id == "self"):
                    out.add(sub.attr)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out.add(node.target.id)
    return out


def members(pkg: Path, rel: str, cls: ast.ClassDef, depth: int = 0) -> set:
    out = own_members(cls)
    if depth < 8:
        for brel, b in bases(pkg, rel, cls):
            out |= members(pkg, brel, b, depth + 1)
    return out


def fields(cls: ast.ClassDef) -> list:
    return [n.target.id for n in cls.body
            if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name)
            and "ClassVar" not in ast.unparse(n.annotation)]


def init_of(cls: ast.ClassDef):
    for node in cls.body:
        if isinstance(node, ast.FunctionDef) and node.name == "__init__":
            return node
    return None


def jax_args(rel: str, cls: ast.ClassDef, depth: int = 0) -> list:
    """A JAX class's own constructor arguments: its ``__init__``'s, else
    its fields, else its nearest base's."""
    init = init_of(cls)
    if init is not None:
        a = init.args
        return [x.arg for x in (a.posonlyargs + a.args + a.kwonlyargs)[1:]]
    own = fields(cls)
    if own or depth >= 8:
        return own
    for brel, b in bases(JAX, rel, cls):
        args = jax_args(brel, b, depth + 1)
        if args:
            return args
    return []


def port_args(rel: str, cls: ast.ClassDef, depth: int = 0) -> set:
    """What a port class's constructor accepts by name: its ``__init__``'s
    arguments (its bases' too where it passes ``*args`` / ``**kwargs`` on,
    or has none), and its fields."""
    out = set(fields(cls))
    init = init_of(cls)
    passes_on = init is None
    if init is not None:
        a = init.args
        out.update(x.arg for x in a.posonlyargs + a.args + a.kwonlyargs)
        passes_on = a.vararg is not None or a.kwarg is not None
    if passes_on and depth < 8:
        for brel, b in bases(PORT, rel, cls):
            out |= port_args(brel, b, depth + 1)
    return out


def top_level(tree: ast.Module) -> dict:
    """Names a module defines or imports at top level."""
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            out[node.name] = node
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                out[(a.asname or a.name).split(".")[0]] = node
        elif isinstance(node, ast.Assign):
            out.update((t.id, node) for t in node.targets
                       if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out[node.target.id] = node
    return out


def missing(rel: str) -> list:
    """The JAX module's public surface with no counterpart in the port."""
    jtree = parse(JAX / rel)
    ppath = PORT / rel
    ptop = top_level(parse(ppath)) if ppath.exists() else {}
    gaps = []
    for node in jtree.body:
        if not isinstance(node, (ast.ClassDef, ast.FunctionDef)) \
                or not public(node.name):
            continue
        if node.name not in ptop:
            gaps.append(f"{rel}:{node.name}")
            continue
        if not isinstance(node, ast.ClassDef):
            continue
        prel, pcls = find_class(PORT, node.name, rel)
        if pcls is None:
            gaps.append(f"{rel}:{node.name}")
            continue
        have = members(PORT, prel, pcls)
        for sub in node.body:
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and public(sub.name) and sub.name not in have:
                gaps.append(f"{rel}:{node.name}.{sub.name}")
        accepted = port_args(prel, pcls)
        gaps += [f"{rel}:{node.name}({a}=)" for a in jax_args(rel, node)
                 if public(a) and a not in accepted]
    return gaps


def allowed(gap: str):
    return [key for key in ALLOWED if fnmatch.fnmatchcase(gap, key)]


@pytest.mark.parametrize("rel", jax_modules())
def test_module_surface(rel):
    """Every public class, function, method and constructor argument of
    the JAX module has a counterpart in the port, or a reason not to."""
    unported = [g for g in missing(rel) if not allowed(g)]
    assert not unported, (f"rlpyt_tpu/{rel}: no counterpart in "
                          f"rlpyt_tpu_torch/{rel}: {unported}")


def test_allowlist_entries_are_needed_and_sourced():
    """Each entry still names something missing, gives a reason and
    points at a line that exists."""
    gaps = [g for rel in jax_modules() for g in missing(rel)]
    for key, (reason, where) in ALLOWED.items():
        assert any(fnmatch.fnmatchcase(g, key) for g in gaps), \
            f"{key} is ported now: drop it from ALLOWED"
        assert len(reason) > 20, key
        m = re.fullmatch(r"(.+):(\d+)", where)
        assert m, f"{key}: {where} is not file:line"
        path, line = ROOT / m.group(1), int(m.group(2))
        assert path.is_file(), f"{key}: {path} does not exist"
        assert 1 <= line <= len(path.read_text().splitlines()), \
            f"{key}: {where} is past the end of the file"


INITS = [rel for rel in jax_modules() if rel.endswith("__init__.py")
         and any(isinstance(n, ast.ImportFrom)
                 for n in parse(JAX / rel).body)]


def reexports(path: Path, package: str) -> dict:
    """name -> source module of each ``from package.x import name``."""
    out = {}
    for node in parse(path).body:
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            for a in node.names:
                out[a.asname or a.name] = node.module
    return out


@pytest.mark.parametrize("rel", INITS)
def test_package_reexports(rel):
    """The port's package re-exports the counterpart of every name the
    JAX package's ``__init__`` exports, from the same submodule, and each
    name is defined there."""
    want = reexports(JAX / rel, "rlpyt_tpu")
    have = reexports(PORT / rel, "rlpyt_tpu_torch")
    assert want, rel
    for name, module in want.items():
        port_module = module.replace("rlpyt_tpu", "rlpyt_tpu_torch", 1)
        assert have.get(name) == port_module, \
            f"rlpyt_tpu_torch/{rel} does not export {name} from {port_module}"
        src = ROOT / (port_module.replace(".", "/") + ".py")
        assert name in top_level(parse(src)), f"{name} not in {src}"


def test_surface_cases_cover_the_package():
    mods = jax_modules()
    assert len(mods) > 70 and "models/conv.py" in mods
    assert not any(m.startswith("ops/pallas/") for m in mods)
    assert set(INITS) == {"models/__init__.py", "distributions/__init__.py",
                          "ops/__init__.py"}
