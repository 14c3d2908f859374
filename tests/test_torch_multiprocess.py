"""Two processes over torch.distributed (gloo) on the CPU, each holding a
2-shard virtual mesh of the 4-shard global mesh: the port's
multihost.compress_dp_global and compress_multihost (the cross-process
manifest and payload all-gathers, process 0 writing the output). Process
0's one-shot and streamed streams must equal the one-process encode_dp
stream. The workers (tests/torch_multiproc.py) run as subprocesses with a
timeout and are reaped on failure. The counterpart of
tests/test_multiprocess.py, which runs the JAX package's layer.
"""

from tpu_snappy_torch import format as fmt
from tpu_snappy_torch import reference_codec
from tpu_snappy_torch.parallel import mesh as meshlib, shard

import torch_multiproc
from torch_edges import block_mix
from torch_threads import share_cores

share_cores()


def test_two_process_gloo_encode():
    data = block_mix(8 * fmt.BLOCK_SIZE + 12345)
    want = shard.encode_dp(data, meshlib.make_mesh(1, device="cpu"))
    # 9 blocks over 4 shards in waves of 8 blocks: two waves.
    out = torch_multiproc.run(data, nprocs=2, shards=("cpu", "cpu"),
                              blocks_per_wave=8, timeout=240)
    assert out["processes"] == 2 and out["global_shards"] == 4
    assert out["oneshot"] == want
    assert out["stream"] == want
    assert out["out_bytes"] == len(want) and out["waves"] == 2
    assert out["in_bytes"] == len(data)
    assert reference_codec.decompress(out["stream"]) == data
