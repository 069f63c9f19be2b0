"""Faults planted under the timed path, by the kind of path: the check
must come out not correct under each (``tests/test_h100bench_faults.py``
on the CPU; ``readings.py --fault`` on the card). Each sets ``cell.wrap``,
which the cell applies to its timed call in set-up."""

import torch


def answer_altered(cell):
    """One answer changed where it is produced: sample 5 of the first
    utterance of every call moved by 0.01."""
    def wrap(timed):
        def call(mels):
            y = timed(mels).copy()
            y[0, 5] += 0.01
            return y
        return call
    cell.wrap = wrap


def half_batch_vocode(cell):
    """Half of the batch left out: the later half's waveforms never made."""
    def wrap(timed):
        def call(mels):
            y = timed(mels).copy()
            y[len(mels) // 2:] = 0.0
            return y
        return call
    cell.wrap = wrap


def state_unchanged(cell):
    """A step that returns its state unchanged: the weights put back."""
    def wrap(steps):
        def call(wav, mel):
            params = [p for net in steps.params().values() for p in net.values()]
            saved = [p.detach().clone() for p in params]
            out = steps(wav, mel)
            with torch.no_grad():
                for p, s in zip(params, saved):
                    p.copy_(s)
            return out
        return call
    cell.wrap = wrap


def half_batch_step(cell):
    """Half of the batch left out, the means taken over the rest."""
    def wrap(steps):
        return lambda wav, mel: steps(wav[:len(wav) // 2], mel[:len(mel) // 2])
    cell.wrap = wrap


FAULTS = {
    "vocode": {"answer_altered": answer_altered, "half_batch": half_batch_vocode},
    "gan_train": {"state_unchanged": state_unchanged, "half_batch": half_batch_step},
}
