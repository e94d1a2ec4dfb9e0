"""Portrait mode's host labelling, a pair: the `portrait.components` spans
(union-find over the dilated mask, its areas, the largest regions kept and
the mask sent back to the device) over the pairs of the `portrait` spans.
The mask's copy to the host, which waits for the device, is the
`portrait.wait` span before it, not counted here."""
from benchmark.program_spans import ms_per_item


def read(obs: dict):
    return ms_per_item(obs, "portrait.components", "portrait")
