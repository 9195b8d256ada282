"""One rank of the sharded-detector parity test (test_torch_port_sharded.py):
the tiny SGTAPose from OUT_DIR/inputs.pt (a state dict and a batch of
videos) served by `infer/detector.make_sharded_video_detector` as rank RANK
of WORLD (a gloo process group over tcp://localhost:PORT), with
`mesh.num_devices` set to WORLD; then the same runner on 3 videos, which 2
ranks cannot split, and a config that asks for WORLD + 2 ranks. Saves the
gathered FrameResult and the two error messages to OUT_DIR/rankRANK.pt.

    python tests/torch_port_sharded_worker.py WORLD RANK PORT OUT_DIR

Imports no JAX.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sgtapose_tpu_torch.config import Config, MeshConfig, ModelConfig  # noqa: E402
from sgtapose_tpu_torch.data import synthetic  # noqa: E402
from sgtapose_tpu_torch.infer import detector  # noqa: E402
from sgtapose_tpu_torch.models.sgta import SGTAPose  # noqa: E402
from sgtapose_tpu_torch.parallel import mesh  # noqa: E402

CFG = Config(model=ModelConfig(input_res=(64, 64), kernel_list=(3, 3, 3, 1, 1, 1)))


def main(world: int, rank: int, port: int, out_dir: str) -> None:
    torch.set_num_threads(2)
    mesh.initialize_multihost(f"localhost:{port}", world, rank, device="cpu")
    try:
        saved = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=True)
        model = SGTAPose(CFG.model).eval()
        model.load_state_dict(saved["state"])
        cfg = Config(model=CFG.model, mesh=MeshConfig(num_devices=world))
        run = detector.make_sharded_video_detector(model, cfg, synthetic.camera_K(),
                                                   (synthetic.RAW_H, synthetic.RAW_W), device="cpu")
        videos = detector.VideoFrames(**saved["videos"])
        res = run(videos)
        try:
            run(detector.VideoFrames(*(x[:3] for x in videos)))
            raised = ""
        except ValueError as e:
            raised = str(e)
        try:
            detector.make_sharded_video_detector(model, Config(model=CFG.model, mesh=MeshConfig(num_devices=world + 2)),
                                                 synthetic.camera_K(), (synthetic.RAW_H, synthetic.RAW_W),
                                                 device="cpu")
            raised_mesh = ""
        except ValueError as e:
            raised_mesh = str(e)
        torch.save({"result": res._asdict(), "raised": raised, "raised_mesh": raised_mesh},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        mesh.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
