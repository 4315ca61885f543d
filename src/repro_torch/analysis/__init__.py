"""`repro_torch.analysis`: the runtime shape contract of the serving ladder.

The counterpart of ``repro.analysis``'s ``recompile`` engine: a sentry
over the serving entry points' call signatures, so the ladder provably
runs exactly its declared rung set. The reference's jaxpr budget and
lint engines are not ported yet.
"""
from repro_torch.analysis.recompile import (RecompileGuardError,
                                            RecompileSentry,
                                            abstract_signature,
                                            ladder_signatures)

__all__ = [
    "RecompileGuardError",
    "RecompileSentry",
    "abstract_signature",
    "ladder_signatures",
]
