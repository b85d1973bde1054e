"""The port's sharding rules on a real (2, 4) mesh of CPU processes.

Mirrors `tests/test_sharding.py::test_lm_train_step_shards_on_mesh` and
`::test_elastic_restore_across_mesh_shapes`.  One child Python spawns 8
processes joined by ``torch.distributed`` over gloo (its own time
limit); the two tests read its report.

* The LM loss: a tiny LM's parameters are laid out as `DTensor`s by the
  dry run's bindings (`launch.specs`: the reference's rules, FSDP over
  "data" and the embedding's columns over "model"), the tokens split
  over "data"; the loss equals the one-process loss within 1e-5.  The
  LM head stays replicated: DTensor's ``gather`` of the label logits
  from a vocabulary-sharded head fails in its mask buffer, and the MoE
  dispatch's ``scatter_`` has no DTensor rule, so the test runs the
  dense config (ROADMAP, standing differences, slice 16).
* Elastic restore: a tensor laid out on a (4, 2) mesh is saved through
  the port's `ckpt.checkpoint.save` and restored with `restore(device=)`
  (the port has no ``shardings=``), then laid out on a (2, 2) mesh of
  four of the processes; the values are equal and the new layout has 2
  shards on "data".
"""

import os
import subprocess
import sys
import textwrap

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = textwrap.dedent("""
    import socket, tempfile
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def worker(rank, port, ckpt_dir):
        torch.set_num_threads(1)
        dist.init_process_group("gloo",
                                init_method=f"tcp://127.0.0.1:{port}",
                                world_size=8, rank=rank)
        from torch.distributed.tensor import (DeviceMesh, Replicate, Shard,
                                              distribute_tensor,
                                              init_device_mesh)
        from torch.distributed.tensor.experimental import (
            implicit_replication)
        from repro_torch.ckpt import checkpoint as CK
        from repro_torch.configs.base import LMConfig
        from repro_torch.launch import specs as SP
        from repro_torch.models import transformer as T

        def placements(spec, axes):
            out = []
            for ax in axes:
                pl = Replicate()
                for i, b in enumerate(spec):
                    names = (b,) if isinstance(b, str) else (b or ())
                    if ax in names:
                        pl = Shard(i)
                out.append(pl)
            return out

        cfg = LMConfig(name="t", n_layers=2, d_model=32, n_heads=4,
                       n_kv_heads=2, d_ff=64, vocab_size=128, d_head=8,
                       dtype="float32", vocab_pad_multiple=64)
        model = T.init_params(0, cfg, device="cpu")
        g = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, 128, (8, 16), generator=g)
        labels = torch.roll(tokens, -1, 1)
        with torch.no_grad():
            ref = float(T.train_step_loss(model, cfg, tokens, labels))

        axes = ("data", "model")
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=axes)
        rule = SP._lm_port_rule(cfg, fsdp=True)
        names = {id(p): n for n, p in model.named_parameters()}
        n_sharded = 0
        for mod in model.modules():
            for name, p in list(mod._parameters.items()):
                if p is None:
                    continue
                full = names[id(p)]
                spec = ((None, None) if full == "lm_head.weight"
                        else rule(full, p))
                pl = placements(spec, axes)
                n_sharded += any(isinstance(x, Shard) for x in pl)
                mod._parameters[name] = torch.nn.Parameter(
                    distribute_tensor(p.detach(), mesh, pl),
                    requires_grad=False)
        tok = distribute_tensor(tokens, mesh, [Shard(0), Replicate()])
        lab = distribute_tensor(labels, mesh, [Shard(0), Replicate()])
        with torch.no_grad(), implicit_replication():
            loss = T.train_step_loss(model, cfg, tok, lab).full_tensor()
        if rank == 0:
            print("LOSS", ref, float(loss), n_sharded, flush=True)

        mesh1 = init_device_mesh("cpu", (4, 2), mesh_dim_names=axes)
        w = torch.arange(64.0).reshape(8, 8)
        placed = distribute_tensor(w, mesh1, [Shard(0), Shard(1)])
        full = placed.full_tensor()
        if rank == 0:
            CK.save(ckpt_dir, 5, {"w": full})
        dist.barrier()
        restored = CK.restore(ckpt_dir, 5, {"w": torch.zeros(8, 8)},
                              device="cpu")
        mesh2 = DeviceMesh("cpu", [[0, 1], [2, 3]], mesh_dim_names=axes)
        if rank < 4:
            again = distribute_tensor(restored["w"], mesh2,
                                      [Shard(0), Shard(1)])
            back = again.full_tensor()
            if rank == 0:
                print("RESTORE", bool(torch.equal(back, w)),
                      again.device_mesh.shape[0],
                      "x".join(map(str, again.to_local().shape)),
                      flush=True)
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        with tempfile.TemporaryDirectory() as d:
            mp.spawn(worker, args=(port, d), nprocs=8)
""")


@pytest.fixture(scope="module")
def mesh_report(tmp_path_factory):
    script = tmp_path_factory.mktemp("mesh") / "child.py"
    script.write_text(_CHILD)
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, str(script)], env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return {line.split()[0]: line.split()[1:]
            for line in r.stdout.splitlines()
            if line.startswith(("LOSS", "RESTORE"))}


def test_lm_train_step_loss_on_dtensor_mesh(mesh_report):
    ref, sharded, n_sharded = mesh_report["LOSS"]
    assert int(n_sharded) > 0
    assert abs(float(sharded) - float(ref)) <= 1e-5 * abs(float(ref))


def test_elastic_restore_across_mesh_shapes(mesh_report):
    equal, data_shards, local = mesh_report["RESTORE"]
    assert equal == "True"
    assert int(data_shards) == 2
    assert local == "4x4"
