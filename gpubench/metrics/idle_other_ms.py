"""The card's idle ms a traced step, in gaps of at least 5 us, while no
phase of the port's step was open on the host: ``train.step``'s own time
(``zero_grad``, the loss's mean) and the time outside every step (the
benchmark's loop). With the three phases' it sums to the idle time less
the gaps under 5 us (``_spans.idle_ms``).

It exists only under the trace and reads mostly the trace's own cost
on the host, which varies between hosts and runs: untraced, the card's idle
is nearly all gaps under 5 us, left out here, so a cut here need not move
``train_tokens_per_s``; ``host_issue_ms`` is the signal for that (PERF.md §3)."""

from ._spans import idle_ms


def read(ctx):
    return idle_ms(ctx, None)
