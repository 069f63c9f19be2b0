"""Gaps of the PyTorch port's bf16 path from the JAX package's, on the CPU.

For the TINY SAM-BERT forward and the small generator of
``tests/test_torch_port_bf16.py`` it prints, per output, e_ref = max
|JAX bf16 - JAX f32| and the ratio max |port - JAX bf16| / e_ref, for the
port in bf16 and for the port left in float32, with the JAX side compiled
with XLA's ``xla_allow_excess_precision`` on (the default) and off.

    JAX_PLATFORMS=cpu python tools/torch_port_bf16_gaps.py
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from kantts_tpu_torch.models.hifigan.generator import Generator  # noqa: E402
from kantts_tpu_torch.models.sambert.sambert import KanTtsSAMBERT  # noqa: E402
from test_torch_port_bf16 import (  # noqa: E402
    _am_batch,
    _am_cfg,
    _f32,
    _gen_pair,
    _j_forward,
    _t_forward,
)
from kantts_tpu_torch.models.builder import init_parameters  # noqa: E402
from kantts_tpu.models.sambert.sambert import KanTtsSAMBERT as JSAMBERT  # noqa: E402
from kantts_tpu.utils.torch_convert import convert_sambert  # noqa: E402


def run(fn, args, excess: bool):
    options = {} if excess else {"xla_allow_excess_precision": False}
    return jax.jit(fn).lower(*args).compile(options)(*args)


def ratios(port_out, j16, j32):
    e_ref = float(np.abs(_f32(j16) - _f32(j32)).max())
    return e_ref, float(np.abs(_f32(port_out) - _f32(j16)).max()) / e_ref


def main():
    rows = []
    b = _am_batch(False)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    ports, params = {}, None
    for bf16 in (False, True):
        port = KanTtsSAMBERT(_am_cfg(False, bf16))
        if params is None:
            init_parameters(port, seed=0)
            params = convert_sambert({k: v.numpy() for k, v in port.state_dict().items()},
                                     _am_cfg(False, False))
            state = port.state_dict()
        port.load_state_dict(state)
        ports[bf16] = port.eval()
    got = {bf16: _t_forward(ports[bf16], b) for bf16 in ports}
    for excess in (True, False):
        want = {bf16: run(_j_forward(JSAMBERT(_am_cfg(False, bf16))), (params, jb), excess)
                for bf16 in (False, True)}
        for key in ("dec_outputs", "postnet_outputs"):
            for port_bf16 in (True, False):
                e_ref, r = ratios(got[port_bf16][key], want[True][key], want[False][key])
                rows.append({"module": f"sambert {key}", "excess_precision": excess,
                             "port": "bf16" if port_bf16 else "float32",
                             "e_ref": e_ref, "gap_over_e_ref": r})
    cfg, gparams, port16, j32, j16, mel = _gen_pair(False)
    port32 = Generator(**cfg)
    port32.load_state_dict(port16.state_dict())
    with torch.no_grad():
        out = {True: port16(torch.from_numpy(mel)), False: port32.eval()(torch.from_numpy(mel))}
    for excess in (True, False):
        want = {bf16: run(lambda p, m, jm=jm: jm.apply({"params": p}, m),
                          (gparams, jnp.asarray(mel)), excess)
                for bf16, jm in ((False, j32), (True, j16))}
        for port_bf16 in (True, False):
            e_ref, r = ratios(out[port_bf16], want[True], want[False])
            rows.append({"module": "generator", "excess_precision": excess,
                         "port": "bf16" if port_bf16 else "float32",
                         "e_ref": e_ref, "gap_over_e_ref": r})
    for row in rows:
        print(json.dumps(row))


if __name__ == "__main__":
    main()
