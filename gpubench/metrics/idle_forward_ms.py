"""The card's idle ms a traced step, in gaps of at least 5 us, while the
innermost of the port's spans open on the host was ``train.forward``
(``_spans.idle_ms``).

It exists only under the trace and reads mostly the trace's own cost
on the host, which varies between hosts and runs: untraced, the card's idle
is nearly all gaps under 5 us, left out here, so a cut here need not move
``train_tokens_per_s``; ``host_issue_ms`` is the signal for that (PERF.md §3)."""

from ._spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "train.forward")
