"""Structured diagnostics for the program analysis passes.

Counterpart of paddle_tpu/analysis/diagnostics.py.  A pass reports
`Diagnostic` records instead of raising ad-hoc exceptions: each record
carries a stable code (docs/ANALYSIS.md documents them), a severity,
and the op/block/var identity needed to act on it.  A `Report`
aggregates them, applies suppressions, publishes per-code counters into
the obs registry, and can be turned into a `ProgramVerificationError`
when a caller wants errors to be fatal (the executor's
FLAGS_verify_program gate, `fluid.io.load_inference_model`, the serving
engine's warmup, the rewrite passes and the DistributeTranspiler do).

Code families:
  V0xx  structural verification (verifier.py)
  D0xx / H0xx  dataflow: dead code and write/alias hazards (dataflow.py)
  L0xx  lints (lints.py)
  A0xx  alias and donation safety (alias.py): A001 a forked or absent
        in-place slot, A002 a read after donation, A003 a fetch of a
        donatable buffer, A004 an in-place update outside a captured
        segment, A005 donation on an unsafe backend

Suppressions are strings, matched most-specific-first:
  "H002"              suppress the code everywhere
  "H002@scale"        suppress the code on ops of one type
  "H002@var:fc_0.w_0" suppress the code for one variable name
"""

__all__ = ["Severity", "Diagnostic", "Report",
           "ProgramVerificationError"]


class Severity:
    """Ordered severities.  `error` findings make verification fail;
    `warning` is a real finding that does not block execution; `info`
    is advisory (e.g. a dynamic batch dim that shape bucketing is
    expected to absorb)."""

    ERROR = "error"
    WARNING = "warning"
    INFO = "info"

    _ORDER = {ERROR: 0, WARNING: 1, INFO: 2}

    @classmethod
    def rank(cls, sev):
        return cls._ORDER.get(sev, 99)


class Diagnostic:
    """One finding.  Identity fields are optional — a program-wide
    finding has no op_index — but every pass fills what it knows so a
    consumer can locate the op without re-running the analysis."""

    __slots__ = ("code", "severity", "message", "block_idx", "op_index",
                 "op_type", "var_name")

    def __init__(self, code, severity, message, block_idx=None,
                 op_index=None, op_type=None, var_name=None):
        self.code = code
        self.severity = severity
        self.message = message
        self.block_idx = block_idx
        self.op_index = op_index
        self.op_type = op_type
        self.var_name = var_name

    def location(self):
        bits = []
        if self.block_idx is not None:
            bits.append("block %d" % self.block_idx)
        if self.op_index is not None:
            bits.append("op %d" % self.op_index)
        if self.op_type:
            bits.append("(%s)" % self.op_type)
        if self.var_name:
            bits.append("var %r" % self.var_name)
        return " ".join(bits)

    def format(self):
        loc = self.location()
        return "[%s:%s] %s%s" % (self.code, self.severity,
                                 (loc + ": ") if loc else "",
                                 self.message)

    def to_dict(self):
        return {k: getattr(self, k) for k in self.__slots__
                if getattr(self, k) is not None}

    def __repr__(self):
        return "Diagnostic(%s)" % self.format()

    def _suppress_keys(self):
        keys = [self.code]
        if self.op_type:
            keys.append("%s@%s" % (self.code, self.op_type))
        if self.var_name:
            keys.append("%s@var:%s" % (self.code, self.var_name))
        return keys


class Report:
    """An ordered collection of diagnostics with suppression filtering
    and severity accounting."""

    def __init__(self, diagnostics=(), suppress=()):
        self.suppressed = []
        self.diagnostics = []
        self._suppress = set(suppress or ())
        for d in diagnostics:
            self.add(d)

    def add(self, diag):
        if any(k in self._suppress for k in diag._suppress_keys()):
            self.suppressed.append(diag)
        else:
            self.diagnostics.append(diag)
        return self

    def extend(self, diags):
        for d in diags:
            self.add(d)
        return self

    def by_severity(self, severity):
        return [d for d in self.diagnostics if d.severity == severity]

    @property
    def errors(self):
        return self.by_severity(Severity.ERROR)

    @property
    def warnings(self):
        return self.by_severity(Severity.WARNING)

    def codes(self):
        return sorted({d.code for d in self.diagnostics})

    def has(self, code):
        return any(d.code == code for d in self.diagnostics)

    def ok(self):
        """True when no error-severity finding survived suppression."""
        return not self.errors

    def sorted(self):
        return sorted(
            self.diagnostics,
            key=lambda d: (Severity.rank(d.severity),
                           d.block_idx if d.block_idx is not None else -1,
                           d.op_index if d.op_index is not None else -1,
                           d.code))

    def format(self, max_lines=None):
        lines = [d.format() for d in self.sorted()]
        if max_lines is not None and len(lines) > max_lines:
            rest = len(lines) - max_lines
            lines = lines[:max_lines] + ["... (%d more)" % rest]
        return "\n".join(lines)

    def to_dict(self):
        return {"diagnostics": [d.to_dict() for d in self.sorted()],
                "suppressed": len(self.suppressed),
                "errors": len(self.errors),
                "warnings": len(self.warnings)}

    def publish(self, origin="analysis"):
        """Count surviving findings into the obs registry
        (`analysis_diagnostics_total{code,severity}` plus an
        `analysis_runs_total{origin}` run counter) so serving warmup /
        executor verification leave a scrapeable trail."""
        from ..obs import registry as registry_mod

        reg = registry_mod.get_registry()
        reg.counter("analysis_runs_total",
                    "program analysis passes executed",
                    labelnames=("origin",)).labels(origin=origin).inc()
        fam = reg.counter("analysis_diagnostics_total",
                          "static-analysis findings by diagnostic code",
                          labelnames=("code", "severity"))
        for d in self.diagnostics:
            fam.labels(code=d.code, severity=d.severity).inc()
        return self

    def raise_on_error(self):
        """Raise ProgramVerificationError when errors survived."""
        if not self.ok():
            raise ProgramVerificationError(self)
        return self


class ProgramVerificationError(RuntimeError):
    """A program failed verification.  The message names the first
    error's code, op index and variable (what you grep the logs for);
    `.report` carries the full structured findings."""

    def __init__(self, report):
        self.report = report
        errs = report.errors
        head = errs[0].format() if errs else "verification failed"
        more = "" if len(errs) <= 1 else " (+%d more)" % (len(errs) - 1)
        super().__init__("program verification failed: %s%s" % (head,
                                                                more))
