"""AST lint engine over the port: repo-specific PyTorch correctness rules
(counterpart of luminaai_tpu/analysis/astlint.py; the rule ids are JAX's).

A small, dependency-free rule framework over `ast`: each rule is a
callable over a parsed file that yields findings; the engine applies
inline waivers (`# lumina: disable=LXnnn -- reason`, on the flagged
line), dedupes, and renders JSON or human output. The catalogue, each
rule beside the JAX one it replaces:

  LX001  version-fragile distributed imports (torch.distributed._tensor,
         torch.distributed._composable) outside parallel/: private paths
         that move between torch releases (the card runs one torch, a CPU
         box another); parallel/ is where the port keeps its wrappers
         (JAX: shard_map outside parallel/mesh.py)
  LX002  host syncs (.item(), .tolist(), .cpu(), .numpy(),
         torch.cuda.synchronize, np.asarray / np.array) inside hot paths:
         the `forward` / `backward` of every class in models/ and ops/,
         the named step functions of _HOT_STEP_FUNCTIONS, and what those
         call by name in the same file (the port has no jit: these are
         the code a CUDA graph would capture; JAX: inside jit bodies)
  LX003  none: branching on a tensor is legal in eager PyTorch, and
         what it costs is a host sync, which LX002 and the runtime
         audit (analysis/trace_audit.py detect_host_syncs) count
  LX004  wall-clock or stdlib / numpy random calls in models/ and ops/
  LX005  a random draw without an explicit `generator=` in models/,
         ops/ and the sampler (inference/generate.py): its numbers would
         come from the global generator, which checkpoints do not save
         (JAX: a PRNG key consumed twice; torch has no keys to reuse)
  LX006  none: torch updates in place where JAX donates buffers; the
         in-place audit of monitoring/attribution.py (donation_audit)
         measures what JAX's step-without-donation rule guarded
  LX007  mutable default arguments on nn.Module constructors
  LX008  bare `except:`, which would swallow torch.cuda.OutOfMemoryError
         (the OOM ladder's signal), KeyboardInterrupt and SystemExit
  LX009  tenant-labeled metric family without a max_label_values budget
         (unbounded /metrics cardinality), as in JAX
  LX010  direct dist.all_to_all*, isend, irecv or batch_isend_irecv
         outside parallel/: collective call sites must stay enumerable
         for the collective audit (trace_audit.enumerate_collectives)
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import (
    Any,
    Callable,
    Dict,
    Iterator,
    List,
    Optional,
    Sequence,
    Set,
    Tuple,
)

SEVERITY_ERROR = "error"
SEVERITY_WARNING = "warning"

# Inline waiver: must carry the rule id; the reason after `--` is
# recorded verbatim into reports so CI output shows WHY it is accepted.
_WAIVER_RE = re.compile(
    r"#\s*lumina:\s*disable=([A-Z0-9, ]+?)\s*(?:--\s*(.*?)\s*)?$"
)


@dataclasses.dataclass
class Finding:
    rule: str
    severity: str
    path: str
    line: int
    col: int
    message: str
    waived: bool = False
    waiver_reason: Optional[str] = None
    # Set by the baseline layer (cli analyze), not by rules: the finding
    # is real but accepted as legacy debt via --baseline.
    baselined: bool = False

    def key(self) -> Tuple[str, str, int, int]:
        return (self.rule, self.path, self.line, self.col)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    name: str
    severity: str
    description: str
    check: Callable[["FileContext"], Iterator[Finding]]


class FileContext:
    """One parsed file plus the lazily built hot-function index."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source)
        self._hot: Optional[List[ast.AST]] = None

    @property
    def norm_path(self) -> str:
        return "/" + self.path.replace("\\", "/")

    def under(self, *dirs: str) -> bool:
        return any(f"/{d}/" in self.norm_path for d in dirs)

    @property
    def hot_functions(self) -> List[ast.AST]:
        if self._hot is None:
            self._hot = _collect_hot_functions(self)
        return self._hot

    def finding(self, rule: "Rule", node: ast.AST, message: str) -> Finding:
        return Finding(
            rule=rule.id,
            severity=rule.severity,
            path=self.path,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
            message=message,
        )


# --------------------------------------------------------------------------
# shared AST helpers
# --------------------------------------------------------------------------


def _dotted(node: ast.AST) -> Optional[str]:
    """Name/Attribute chain as 'a.b.c'; None for anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _calls(node: ast.AST) -> Iterator[ast.Call]:
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            yield n


# The step functions outside models/ and ops/ whose bodies run once per
# training step on the card (the JAX train step is one jitted program).
_HOT_STEP_FUNCTIONS: Dict[str, Tuple[str, ...]] = {
    "parallel/train_step.py": (
        "train_step", "loss_fn", "loss", "_accumulate_grads", "micro",
        "accumulate_fsdp", "accumulate_local", "eval_loss",
    ),
    "training/optimizer.py": ("apply",),
}


def _collect_hot_functions(ctx: FileContext) -> List[ast.AST]:
    """Roots (forward/backward methods in models/ and ops/, the named
    step functions) and, transitively, the functions of the same file
    they call by name (`f(...)`, `self.f(...)`, `cls.f(...)`)."""
    byname: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            byname.setdefault(node.name, []).append(node)
    roots: List[ast.AST] = []
    if ctx.under("models", "ops"):
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                roots += [f for f in node.body
                          if isinstance(f, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))
                          and f.name in ("forward", "backward")]
    for suffix, names in _HOT_STEP_FUNCTIONS.items():
        if ctx.norm_path.endswith("/" + suffix):
            for name in names:
                roots += byname.get(name, [])
    seen: Dict[int, ast.AST] = {}
    stack = list(roots)
    while stack:
        fn = stack.pop()
        if id(fn) in seen:
            continue
        seen[id(fn)] = fn
        for call in _calls(fn):
            f = call.func
            name = None
            if isinstance(f, ast.Name):
                name = f.id
            elif (isinstance(f, ast.Attribute)
                  and isinstance(f.value, ast.Name)
                  and f.value.id in ("self", "cls")):
                name = f.attr
            if name:
                stack += byname.get(name, [])
    return list(seen.values())


# --------------------------------------------------------------------------
# LX001 — version-fragile distributed imports outside parallel/
# --------------------------------------------------------------------------

_FRAGILE_MODULES = ("torch.distributed._tensor",
                    "torch.distributed._composable")


def _fragile(name: str) -> bool:
    return any(name == m or name.startswith(m + ".")
               for m in _FRAGILE_MODULES)


def _check_lx001(ctx: FileContext) -> Iterator[Finding]:
    if ctx.under("parallel"):
        return
    msg = ("version-fragile import of {name}: private torch.distributed "
           "paths move between torch releases; keep them behind "
           "luminaai_tpu_torch/parallel/")
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if _fragile(a.name):
                    yield ctx.finding(LX001, node, msg.format(name=a.name))
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mod = node.module or ""
            names = [mod] + [f"{mod}.{a.name}" for a in node.names]
            hit = next((n for n in names if _fragile(n)), None)
            if hit:
                yield ctx.finding(LX001, node, msg.format(name=hit))
        elif isinstance(node, ast.Attribute):
            d = _dotted(node)
            if d and _fragile(d) and not _fragile(
                    d.rsplit(".", 1)[0]):
                yield ctx.finding(LX001, node, msg.format(name=d))


# --------------------------------------------------------------------------
# LX002 — host syncs inside hot paths
# --------------------------------------------------------------------------

_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
_SYNC_CALLS = ("torch.cuda.synchronize", "np.asarray", "np.array",
               "numpy.asarray", "numpy.array")


def _check_lx002(ctx: FileContext) -> Iterator[Finding]:
    for fn in ctx.hot_functions:
        for call in _calls(fn):
            d = _dotted(call.func)
            what = None
            if d in _SYNC_CALLS:
                what = d
            elif (isinstance(call.func, ast.Attribute)
                  and call.func.attr in _SYNC_METHODS and not call.args):
                what = f".{call.func.attr}()"
            if what:
                yield ctx.finding(
                    LX002, call,
                    f"host sync {what} inside the hot path "
                    f"'{fn.name}': the host waits for the card, and a "
                    "CUDA graph could not capture it")


# --------------------------------------------------------------------------
# LX004 — wall-clock / stdlib random in models/ and ops/
# --------------------------------------------------------------------------

_TIME_CALLS = ("time.time", "time.perf_counter", "time.monotonic",
               "time.time_ns", "time.perf_counter_ns",
               "time.monotonic_ns")
_RANDOM_PREFIXES = ("random.", "np.random.", "numpy.random.")


def _check_lx004(ctx: FileContext) -> Iterator[Finding]:
    if not ctx.under("models", "ops"):
        return
    for call in _calls(ctx.tree):
        d = _dotted(call.func) or ""
        if d in _TIME_CALLS or d.startswith(_RANDOM_PREFIXES):
            yield ctx.finding(
                LX004, call,
                f"nondeterministic call {d}() in model/op code: results "
                "must depend on inputs, weights and the step's generator "
                "only")


# --------------------------------------------------------------------------
# LX005 — random draws without an explicit generator
# --------------------------------------------------------------------------

_DRAW_FUNCTIONS = ("rand", "randn", "randint", "randperm", "multinomial",
                   "bernoulli", "normal", "poisson", "rand_like",
                   "randn_like", "randint_like")
_DRAW_METHODS = ("uniform_", "normal_", "exponential_", "bernoulli_",
                 "random_", "cauchy_", "log_normal_", "geometric_")
_NO_GENERATOR = ("dropout", "dropout1d", "dropout2d", "alpha_dropout",
                 "feature_alpha_dropout")


def _check_lx005(ctx: FileContext) -> Iterator[Finding]:
    sampler = ctx.norm_path.endswith("/inference/generate.py")
    if not (ctx.under("models", "ops") or sampler):
        return
    for call in _calls(ctx.tree):
        d = _dotted(call.func) or ""
        base = d.rsplit(".", 1)[-1] if d else (
            call.func.attr if isinstance(call.func, ast.Attribute) else "")
        head = d.split(".", 1)[0]
        kws = {k.arg for k in call.keywords}
        if base in _NO_GENERATOR and head in ("F", "torch", "nn"):
            why = "takes no generator"
        elif "generator" in kws:
            continue
        elif base in _DRAW_FUNCTIONS and head == "torch":
            why = "has no generator="
        elif isinstance(call.func, ast.Attribute) and (
                call.func.attr in _DRAW_METHODS):
            why = "has no generator="
        else:
            continue
        yield ctx.finding(
            LX005, call,
            f"random draw {d or base}() {why}: its numbers come from the "
            "global generator, which no checkpoint saves; draw from the "
            "step's torch.Generator")


# --------------------------------------------------------------------------
# LX007 — mutable default arguments on nn.Module constructors
# --------------------------------------------------------------------------


def _is_module_class(node: ast.ClassDef) -> bool:
    return any((_dotted(b) or "").rsplit(".", 1)[-1] == "Module"
               for b in node.bases)


def _mutable(node: Optional[ast.AST]) -> bool:
    return isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                             ast.DictComp, ast.SetComp)) or (
        isinstance(node, ast.Call)
        and (_dotted(node.func) or "") in ("list", "dict", "set"))


def _check_lx007(ctx: FileContext) -> Iterator[Finding]:
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.ClassDef) and _is_module_class(node)):
            continue
        for fn in node.body:
            if not (isinstance(fn, ast.FunctionDef)
                    and fn.name == "__init__"):
                continue
            a = fn.args
            params = a.posonlyargs + a.args
            pairs = list(zip(params[len(params) - len(a.defaults):],
                             a.defaults))
            pairs += [(p, d) for p, d in zip(a.kwonlyargs, a.kw_defaults)
                      if d is not None]
            for param, default in pairs:
                if _mutable(default):
                    yield ctx.finding(
                        LX007, default,
                        f"mutable default for nn.Module argument "
                        f"'{param.arg}': one object shared by every "
                        "instance; default to None or a tuple")


# --------------------------------------------------------------------------
# LX008 — bare except
# --------------------------------------------------------------------------


def _check_lx008(ctx: FileContext) -> Iterator[Finding]:
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            yield ctx.finding(
                LX008, node,
                "bare `except:` swallows torch.cuda.OutOfMemoryError (and "
                "KeyboardInterrupt/SystemExit) — catch a concrete "
                "exception type so device failures surface")


# --------------------------------------------------------------------------
# LX009 — tenant-labeled metric family without a label-value budget
# --------------------------------------------------------------------------


def _labelnames_has_tenant(value: ast.AST) -> bool:
    if isinstance(value, (ast.Tuple, ast.List)):
        return any(isinstance(e, ast.Constant) and e.value == "tenant"
                   for e in value.elts)
    return False


def _check_lx009(ctx: FileContext) -> Iterator[Finding]:
    """Every family carrying a 'tenant' label must declare a
    max_label_values budget (the registry collapses the overflow into
    `_overflow`). Covers the direct registration call and the
    shared-kwargs dict idiom (tk = dict(labelnames=("tenant",), ...))."""
    msg = ("metric family labeled by 'tenant' without a max_label_values "
           "budget — tenant cardinality must be bounded (--max-tenants) "
           "or one tenant scan explodes /metrics")
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            kws = {k.arg: k.value for k in node.keywords if k.arg}
            if "labelnames" in kws and _labelnames_has_tenant(
                    kws["labelnames"]) and "max_label_values" not in kws:
                yield ctx.finding(LX009, node, msg)
        elif isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys
                    if isinstance(k, ast.Constant)]
            if "labelnames" in keys and "max_label_values" not in keys:
                for k, v in zip(node.keys, node.values):
                    if (isinstance(k, ast.Constant)
                            and k.value == "labelnames"
                            and _labelnames_has_tenant(v)):
                        yield ctx.finding(LX009, node, msg)


# --------------------------------------------------------------------------
# LX010 — raw point-to-point and all-to-all collectives outside parallel/
# --------------------------------------------------------------------------

_COLLECTIVE_NAMES = ("all_to_all", "all_to_all_single", "isend", "irecv",
                     "batch_isend_irecv")
_DIST_PREFIXES = ("dist", "torch.distributed", "distributed")


def _check_lx010(ctx: FileContext) -> Iterator[Finding]:
    if ctx.under("parallel"):
        return
    msg = ("direct {name} use: route through luminaai_tpu_torch.parallel "
           "(mesh.py, expert_dispatch.py) — collective call sites outside "
           "parallel/ escape the collective audit")
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ImportFrom) and (
                node.module or "") == "torch.distributed":
            hit = next((a.name for a in node.names
                        if a.name in _COLLECTIVE_NAMES), None)
            if hit:
                yield ctx.finding(LX010, node, msg.format(name=hit))
        elif isinstance(node, ast.Call):
            d = _dotted(node.func) or ""
            prefix, _, name = d.rpartition(".")
            if name in _COLLECTIVE_NAMES and prefix in _DIST_PREFIXES:
                yield ctx.finding(LX010, node, msg.format(name=d))


# --------------------------------------------------------------------------
# registry / engine
# --------------------------------------------------------------------------

LX001 = Rule(
    "LX001", "fragile-distributed-import", SEVERITY_ERROR,
    "private torch.distributed imports outside parallel/",
    _check_lx001,
)
LX002 = Rule(
    "LX002", "host-sync-in-hot-path", SEVERITY_ERROR,
    "host-sync calls inside forwards and step functions",
    _check_lx002,
)
LX004 = Rule(
    "LX004", "nondeterminism", SEVERITY_ERROR,
    "wall-clock / stdlib-random calls in model or op code",
    _check_lx004,
)
LX005 = Rule(
    "LX005", "draw-without-generator", SEVERITY_ERROR,
    "random draws without an explicit torch.Generator",
    _check_lx005,
)
LX007 = Rule(
    "LX007", "mutable-module-default", SEVERITY_ERROR,
    "mutable default arguments on nn.Module constructors",
    _check_lx007,
)
LX008 = Rule(
    "LX008", "bare-except", SEVERITY_WARNING,
    "bare except swallowing torch.cuda.OutOfMemoryError",
    _check_lx008,
)
LX009 = Rule(
    "LX009", "tenant-label-budget", SEVERITY_ERROR,
    "tenant-labeled metric family without max_label_values budget",
    _check_lx009,
)
LX010 = Rule(
    "LX010", "raw-collective-outside-parallel", SEVERITY_ERROR,
    "direct all_to_all/isend/irecv/batch_isend_irecv outside parallel/",
    _check_lx010,
)

# LX003 and LX006 have no torch counterpart (the catalogue above says why).
ALL_RULES: Tuple[Rule, ...] = (
    LX001, LX002, LX004, LX005, LX007, LX008, LX009, LX010,
)

RULES_BY_ID: Dict[str, Rule] = {r.id: r for r in ALL_RULES}


def _apply_waivers(ctx: FileContext, findings: List[Finding]) -> None:
    for f in findings:
        if f.line - 1 >= len(ctx.lines):
            continue
        m = _WAIVER_RE.search(ctx.lines[f.line - 1])
        if not m:
            continue
        ids = {s.strip() for s in m.group(1).split(",")}
        if f.rule in ids or "ALL" in ids:
            f.waived = True
            f.waiver_reason = (m.group(2) or "").strip() or None


def lint_source(
    source: str,
    path: str = "<memory>",
    rules: Sequence[Rule] = ALL_RULES,
) -> List[Finding]:
    """Lint one source blob. Returns ALL findings (waived ones carry
    waived=True); syntax errors surface as a single LX000 finding so a
    broken file fails the gate rather than passing silently."""
    try:
        ctx = FileContext(path, source)
    except SyntaxError as e:
        return [Finding(rule="LX000", severity=SEVERITY_ERROR, path=path,
                        line=e.lineno or 1, col=e.offset or 0,
                        message=f"syntax error: {e.msg}")]
    findings: List[Finding] = []
    seen: Set[Tuple[str, str, int, int]] = set()
    for rule in rules:
        for f in rule.check(ctx):
            if f.key() in seen:
                continue
            seen.add(f.key())
            findings.append(f)
    _apply_waivers(ctx, findings)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def iter_python_files(paths: Sequence[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        else:
            for root, dirs, files in os.walk(p):
                # Skip hidden trees (.git, .venv, ...) and vendored code:
                # analyze lints what the repo owns.
                dirs[:] = sorted(
                    d for d in dirs
                    if not d.startswith(".")
                    and d not in ("__pycache__", "site-packages",
                                  "node_modules", "venv")
                )
                for name in sorted(files):
                    if name.endswith(".py"):
                        yield os.path.join(root, name)


def lint_paths(
    paths: Sequence[str],
    rules: Sequence[Rule] = ALL_RULES,
    rel_to: Optional[str] = None,
) -> List[Finding]:
    findings: List[Finding] = []
    for path in iter_python_files(paths):
        with open(path, "r", encoding="utf-8") as fh:
            source = fh.read()
        shown = os.path.relpath(path, rel_to) if rel_to else path
        findings.extend(lint_source(source, shown, rules))
    return findings


def findings_to_json(
    findings: Sequence[Finding], extra: Optional[Dict[str, Any]] = None
) -> Dict[str, Any]:
    unwaived = [f for f in findings if not f.waived]
    out: Dict[str, Any] = {
        "findings": [f.to_dict() for f in findings],
        "summary": {
            "total": len(findings),
            "unwaived": len(unwaived),
            "waived": len(findings) - len(unwaived),
            "by_rule": _count_by_rule(findings),
        },
        "rules": {
            r.id: {"name": r.name, "severity": r.severity,
                   "description": r.description}
            for r in ALL_RULES
        },
    }
    if extra:
        out.update(extra)
    return out


def _count_by_rule(findings: Sequence[Finding]) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return counts


def format_findings(findings: Sequence[Finding]) -> str:
    if not findings:
        return "astlint: clean (0 findings)"
    lines = []
    for f in findings:
        if f.waived:
            tag = " [waived%s]" % (
                f": {f.waiver_reason}" if f.waiver_reason else "")
        elif f.baselined:
            tag = " [baselined: accepted legacy finding]"
        else:
            tag = ""
        lines.append(f"{f.path}:{f.line}:{f.col}: {f.rule} ({f.severity}) "
                     f"{f.message}{tag}")
    unwaived = sum(1 for f in findings if not (f.waived or f.baselined))
    lines.append(f"astlint: {len(findings)} finding(s), {unwaived} unwaived")
    return "\n".join(lines)
