"""The extended-SPARQL AST shared by the parser, executors, and RSP builder.

Parity: ``shared/src/query.rs`` (346 LoC of enums/structs): filter
expressions with full precedence, arithmetic, VALUES, INSERT/DELETE,
subqueries, ML.PREDICT, model/neural-relation/train declarations, windowing
(RSP-QL), sync policies, stream types, PROB annotations, combined rules,
RETRIEVE, and the top-level CombinedQuery.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional, Tuple, Union


# --------------------------------------------------------------------------
# Filter / arithmetic expressions  (query.rs:15-57)
# --------------------------------------------------------------------------


@dataclass
class Comparison:
    """``left <op> right`` where sides are ArithmeticExpression."""

    left: "ArithExpr"
    op: str  # = != < <= > >=
    right: "ArithExpr"


@dataclass
class LogicalAnd:
    left: "FilterExpression"
    right: "FilterExpression"


@dataclass
class LogicalOr:
    left: "FilterExpression"
    right: "FilterExpression"


@dataclass
class LogicalNot:
    inner: "FilterExpression"


@dataclass
class FunctionCall:
    """Builtin or UDF call in filter context, e.g. ``BOUND(?x)``,
    ``isTRIPLE(?t)``, ``REGEX(?s, "pat")``."""

    name: str
    args: List["ArithExpr"]


FilterExpression = Union[Comparison, LogicalAnd, LogicalOr, LogicalNot, FunctionCall]


@dataclass
class Var:
    name: str


@dataclass
class NumberLit:
    value: float


@dataclass
class StringLit:
    value: str  # stored-term form (quoted lexical)


@dataclass
class IriRef:
    iri: str  # expanded


@dataclass
class ArithOp:
    left: "ArithExpr"
    op: str  # + - * /
    right: "ArithExpr"


@dataclass
class FuncExpr:
    name: str
    args: List["ArithExpr"]


@dataclass
class QuotedPattern:
    """RDF-star quoted triple in expression/pattern position."""

    subject: "ArithExpr"
    predicate: "ArithExpr"
    object: "ArithExpr"


ArithExpr = Union[Var, NumberLit, StringLit, IriRef, ArithOp, FuncExpr, QuotedPattern]


# --------------------------------------------------------------------------
# Patterns and clauses
# --------------------------------------------------------------------------


@dataclass
class PatternTerm:
    """Unresolved pattern position: variable, term string, or quoted pattern."""

    kind: str  # "var" | "term" | "quoted"
    value: Union[str, Tuple["PatternTerm", "PatternTerm", "PatternTerm"]]

    @staticmethod
    def var(name: str) -> "PatternTerm":
        return PatternTerm("var", name)

    @staticmethod
    def term(text: str) -> "PatternTerm":
        return PatternTerm("term", text)

    @property
    def is_var(self) -> bool:
        return self.kind == "var"


@dataclass
class PatternTriple:
    subject: PatternTerm
    predicate: PatternTerm
    object: PatternTerm

    def variables(self) -> List[str]:
        out = []
        for t in (self.subject, self.predicate, self.object):
            if t.kind == "var":
                out.append(t.value)  # type: ignore[arg-type]
            elif t.kind == "quoted":
                s, p, o = t.value  # type: ignore[misc]
                out.extend(PatternTriple(s, p, o).variables())
        return out


@dataclass
class BindClause:
    expr: ArithExpr
    var: str


@dataclass
class ValuesClause:
    variables: List[str]
    rows: List[List[Optional[str]]]  # term strings; None = UNDEF


@dataclass
class Aggregate:
    func: str  # COUNT SUM AVG MIN MAX GROUP_CONCAT SAMPLE
    var: Optional[str]  # argument variable; None = * (COUNT only)
    alias: str
    distinct: bool = False


@dataclass
class SelectItem:
    """Projection item: plain variable, aggregate, or expression AS alias."""

    kind: str  # "var" | "agg" | "expr"
    var: Optional[str] = None
    agg: Optional[Aggregate] = None
    expr: Optional[ArithExpr] = None
    alias: Optional[str] = None


@dataclass
class OrderCondition:
    expr: ArithExpr
    descending: bool = False


@dataclass
class InsertClause:
    triples: List[PatternTriple]


@dataclass
class DeleteClause:
    triples: List[PatternTriple]
    where: Optional["WhereClause"] = None


@dataclass
class SubQuery:
    query: "SelectQuery"


@dataclass
class NotBlock:
    """NAF block in rule bodies: ``NOT { patterns }`` (parser.rs:699)."""

    patterns: List[PatternTriple]


@dataclass
class WindowBlock:
    """``WINDOW :w { patterns }`` inside WHERE (parser.rs:664)."""

    window_iri: str
    patterns: List[PatternTriple]
    filters: List[FilterExpression] = field(default_factory=list)


@dataclass
class WhereClause:
    patterns: List[PatternTriple] = field(default_factory=list)
    filters: List[FilterExpression] = field(default_factory=list)
    binds: List[BindClause] = field(default_factory=list)
    values: Optional[ValuesClause] = None
    subqueries: List[SubQuery] = field(default_factory=list)
    not_blocks: List[NotBlock] = field(default_factory=list)
    window_blocks: List[WindowBlock] = field(default_factory=list)
    optionals: List["WhereClause"] = field(default_factory=list)
    unions: List[List["WhereClause"]] = field(default_factory=list)
    minus: List["WhereClause"] = field(default_factory=list)


# --------------------------------------------------------------------------
# Windowing / RSP-QL  (query.rs:172-252)
# --------------------------------------------------------------------------


class WindowType(Enum):
    SLIDING = "sliding"
    TUMBLING = "tumbling"


@dataclass
class WindowSpec:
    """``[RANGE n STEP m]`` / ``[SLIDING n SLIDE m]`` / ``[TUMBLING n]`` with
    optional ``REPORT <strategy>`` and ``TICK <strategy>``."""

    width: int  # RANGE (time units / item count)
    slide: int  # STEP
    window_type: WindowType = WindowType.SLIDING
    report: str = "ON_WINDOW_CLOSE"  # NON_EMPTY_CONTENT|ON_CONTENT_CHANGE|ON_WINDOW_CLOSE|PERIODIC
    tick: str = "TIME_DRIVEN"  # TIME_DRIVEN | TUPLE_DRIVEN


class SyncPolicyKind(Enum):
    STEAL = "steal"
    WAIT = "wait"
    TIMEOUT = "timeout"


class TimeoutFallback(Enum):
    STEAL = "steal"
    DROP = "drop"


@dataclass
class SyncPolicy:
    """Multi-window coordination policy (query.rs:203-217)."""

    kind: SyncPolicyKind = SyncPolicyKind.STEAL
    timeout_ms: int = 0
    fallback: TimeoutFallback = TimeoutFallback.STEAL


class StreamType(Enum):
    RSTREAM = "RSTREAM"
    ISTREAM = "ISTREAM"
    DSTREAM = "DSTREAM"


@dataclass
class WindowClause:
    """``FROM NAMED WINDOW :w ON :stream [RANGE n STEP m]``."""

    window_iri: str
    stream_iri: str
    spec: WindowSpec
    policy: Optional[SyncPolicy] = None


@dataclass
class RegisterClause:
    """``REGISTER RSTREAM :out AS SELECT ...`` (query.rs:228-252)."""

    stream_type: StreamType
    output_iri: str
    select: "SelectQuery"
    windows: List[WindowClause] = field(default_factory=list)


# --------------------------------------------------------------------------
# ML / neurosymbolic declarations  (query.rs:101-169)
# --------------------------------------------------------------------------


class LossFn(Enum):
    CROSS_ENTROPY = "cross_entropy"
    NLL = "nll"
    MSE = "mse"
    BCE = "bce"


class OptimizerKind(Enum):
    ADAM = "adam"
    SGD = "sgd"


@dataclass
class ModelArch:
    """MLP architecture: hidden layer sizes."""

    hidden: List[int] = field(default_factory=lambda: [16])


@dataclass
class NeuralOutputKind:
    """``OUTPUT BINARY`` or ``OUTPUT EXCLUSIVE { "l0", "l1", ... }``."""

    kind: str  # "binary" | "exclusive"
    labels: List[str] = field(default_factory=list)


@dataclass
class ModelDecl:
    """``MODEL "name" { ARCH MLP { HIDDEN [64, 32] } OUTPUT ... }``."""

    name: str
    arch: ModelArch
    output: NeuralOutputKind = field(
        default_factory=lambda: NeuralOutputKind("binary")
    )
    options: Dict[str, str] = field(default_factory=dict)


@dataclass
class NeuralRelationDecl:
    """``NEURAL RELATION pred USING MODEL "m" { INPUT {...} FEATURES {...} }``."""

    predicate: str
    model_name: str
    input_patterns: List[PatternTriple] = field(default_factory=list)
    anchor_var: str = ""  # subject variable of the first input pattern
    feature_vars: List[str] = field(default_factory=list)


@dataclass
class TrainNeuralRelationDecl:
    """``TRAIN NEURAL RELATION pred { DATA{...}|QUERY{...} LABEL ?l
    TARGET {...} LOSS .. OPTIMIZER .. ... }``."""

    relation: str
    data_patterns: List[PatternTriple] = field(default_factory=list)
    data_query: Optional[str] = None
    label_var: str = ""
    target: Optional[PatternTriple] = None
    loss: LossFn = LossFn.BCE
    optimizer: OptimizerKind = OptimizerKind.ADAM
    epochs: int = 10
    batch_size: int = 32
    learning_rate: float = 0.01
    save_path: Optional[str] = None


@dataclass
class MLPredictClause:
    """``ML.PREDICT(MODEL :m, INPUT { SELECT ... }, OUTPUT ?var)``
    (query.rs:101-108)."""

    model: str
    input_select: "SelectQuery"
    output_var: str


# --------------------------------------------------------------------------
# Probabilistic annotation + rules  (query.rs:257-306)
# --------------------------------------------------------------------------


@dataclass
class ProbAnnotation:
    combination: str = "minmax"  # minmax | addmult | boolean | topk | wmc | sdd
    threshold: Optional[float] = None
    confidence: Optional[float] = None
    k: int = 5  # topk proof budget (reference default, parser.rs:2679)


@dataclass
class CombinedRule:
    """``RULE :Name(?a, ?b) :- body => { conclusions }`` (query.rs:265-284)."""

    name: str
    params: List[str]
    body: WhereClause
    conclusions: List[PatternTriple]
    prob: Optional[ProbAnnotation] = None
    windows: List[WindowClause] = field(default_factory=list)
    ml_predict: Optional[MLPredictClause] = None
    stream_type: Optional[StreamType] = None


@dataclass
class RetrieveClause:
    """``RETRIEVE SOME|EVERY ACTIVE|LATENT STREAM ?s FROM <catalog> WITH
    { patterns }`` (query.rs:299-306, parser.rs:2067-2144)."""

    mode: str  # SOME | EVERY
    state: str  # ACTIVE | LATENT
    variable: str  # stream variable, e.g. "s"
    from_iri: str  # catalog IRI
    with_patterns: List[PatternTriple] = field(default_factory=list)


# --------------------------------------------------------------------------
# Queries
# --------------------------------------------------------------------------


@dataclass
class SelectQuery:
    select: List[SelectItem]
    where: WhereClause
    distinct: bool = False
    group_by: List[str] = field(default_factory=list)
    order_by: List[OrderCondition] = field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None
    prefixes: Dict[str, str] = field(default_factory=dict)

    def select_all(self) -> bool:
        return len(self.select) == 1 and self.select[0].kind == "var" and self.select[0].var == "*"


@dataclass
class CombinedQuery:
    """Top-level parse result (query.rs:320-345): any combination of
    declarations, rules, a select/register query, and updates."""

    select: Optional[SelectQuery] = None
    register: Optional[RegisterClause] = None
    rules: List[CombinedRule] = field(default_factory=list)
    insert: Optional[InsertClause] = None
    delete: Optional[DeleteClause] = None
    models: List[ModelDecl] = field(default_factory=list)
    neural_relations: List[NeuralRelationDecl] = field(default_factory=list)
    train_decls: List[TrainNeuralRelationDecl] = field(default_factory=list)
    ml_predict: Optional[MLPredictClause] = None
    retrieve: Optional[RetrieveClause] = None
    prefixes: Dict[str, str] = field(default_factory=dict)
