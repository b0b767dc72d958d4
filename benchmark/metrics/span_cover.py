"""The program's leaf spans' event time over the traced slice's busy time,
in %: how much of the card's work the phase metrics place
(``benchmark/spans.py``). An event interval also holds the gaps between
kernels and any wait of the card on the host, which the busy time does
not, so it reads over 100 by as much as the slice holds of those."""
from benchmark.spans import cover

read = cover
