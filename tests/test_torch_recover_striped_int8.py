"""``--recover --quantize-grads --edst-engine striped`` in the train entry
point, against the reference's, which accepts it (it refuses ``--recover``
only off ``--sync edst`` and with ``--zero1``): the reduced smollm-135m on
the ``--mesh 2,2`` data x model mesh (the reference on 4 fake CPU
devices), 3 steps, each run's recovery journal read from its
``--journal-out`` file.  Both commit every step and journal the same
entries: none, as the striped int8 rows agree (the port's ``sync_dev``
is 0), so the controller reads no corruption.
"""
import json

import numpy as np

from repro_torch.launch import train

ARGS = ["--arch", "smollm-135m", "--reduced", "--mesh", "2,2", "--steps",
        "3", "--batch", "16", "--seq", "16", "--sync", "edst", "--recover",
        "--quantize-grads", "--edst-engine", "striped", "--log-every", "1"]

REF_CODE = r"""
import json
from repro.launch import train
losses = train.main(ARGS + ["--journal-out", JOURNAL])
print("LOSSES " + json.dumps([float(x) for x in losses]))
"""


def _rows(path):
    return [json.loads(line) for line in path.read_text().splitlines()] \
        if path.exists() else []


def test_journal_equals_the_reference(subproc, tmp_path):
    ref_journal = tmp_path / "ref.jsonl"
    out = subproc(f"ARGS = {ARGS!r}\nJOURNAL = {str(ref_journal)!r}\n"
                  + REF_CODE, 4, timeout=300)
    ref_losses = json.loads(out.split("LOSSES ", 1)[1].splitlines()[0])
    journal = tmp_path / "port.jsonl"
    res = train.main(ARGS + ["--device", "cpu", "--journal-out",
                             str(journal)])
    assert len(ref_losses) == len(res.losses) == 3
    assert np.all(np.isfinite(res.losses))
    assert res.controller.journal_rows() == _rows(journal) \
        == _rows(ref_journal) == []
    assert float(res.metrics["sync_dev"]) == 0.0
