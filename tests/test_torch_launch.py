"""The port's Slurm launcher (mingpt_distributed_tpu_torch/launch/slurm_run.sh)
on the CPU: ``scontrol`` and ``srun`` are shims on PATH under a one-node
Slurm environment. The first test reads the exact torch.distributed.run
command line srun is given; the second lets srun run it here, 2 gloo ranks
on the CPU through a c10d rendezvous on the head node, and trains gpt-nano
for 2 steps."""

import os
import socket
import stat
import subprocess
import sys
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "mingpt_distributed_tpu_torch", "launch", "slurm_run.sh")


def _shim(path, body):
    path.write_text("#!/usr/bin/env bash\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)


def _slurm(tmp_path, head, srun_body, gpus=2, **env):
    """The launcher under shims: scontrol names ``head`` first of two
    hosts, srun runs ``srun_body``; python is this interpreter."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    _shim(bin_dir / "scontrol",
          f'[ "$1 $2 $3" = "show hostnames node-[01-02]" ] || exit 9\n'
          f'printf "%s\\n" {head} node-02\n')
    _shim(bin_dir / "srun", srun_body)
    _shim(bin_dir / "python", f'exec {sys.executable} "$@"\n')
    full = {k: v for k, v in os.environ.items() if not k.startswith("SLURM_")}
    full.pop("LOGLEVEL", None)
    full.update(PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
                SLURM_JOB_NODELIST="node-[01-02]", SLURM_NNODES="1",
                SLURM_JOB_ID="4242", SLURM_GPUS_ON_NODE=str(gpus), **env)
    return full


def test_launcher_command_line(tmp_path):
    argv_file, env_file = tmp_path / "argv", tmp_path / "env"
    env = _slurm(tmp_path, "node-01",
                 f'printf "%s\\n" "$@" > {argv_file}\necho "$LOGLEVEL" > {env_file}\n',
                 gpus=8)
    proc = subprocess.run(["bash", SCRIPT, "--config", "gpt2_config.yaml",
                           "trainer_config.mesh.dp=16"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert argv_file.read_text().splitlines() == [
        "python", "-m", "torch.distributed.run", "--nnodes", "1",
        "--nproc-per-node", "8", "--rdzv-backend", "c10d",
        "--rdzv-endpoint", "node-01:29500", "--rdzv-id", "4242",
        "-m", "mingpt_distributed_tpu_torch.train", "--dist-backend", "nccl",
        "--config", "gpt2_config.yaml", "trainer_config.mesh.dp=16"]
    assert env_file.read_text().strip() == "INFO"


def test_launcher_reads_the_head_of_a_long_node_list(tmp_path):
    """A node list far longer than a pipe's buffer: the launcher reads it
    whole, so scontrol is never cut off by SIGPIPE, and the first node is
    the rendezvous host."""
    argv_file = tmp_path / "argv"
    env = _slurm(tmp_path, "node-01", f'printf "%s\\n" "$@" > {argv_file}\n')
    _shim(tmp_path / "bin" / "scontrol",
          'echo node-0001\nfor i in $(seq 2 20000); do echo "node-$i"; done\n')
    proc = subprocess.run(["bash", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "node-0001:29500" in argv_file.read_text().splitlines()


def test_launcher_refuses_an_allocation_without_gpus(tmp_path):
    env = _slurm(tmp_path, "node-01", "exit 0\n")
    env.pop("SLURM_GPUS_ON_NODE")
    proc = subprocess.run(["bash", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0 and "no GPUs in the allocation" in proc.stderr


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_launcher_trains_two_gloo_ranks_on_the_cpu(tmp_path):
    env = _slurm(tmp_path, "localhost", 'exec "$@"\n', gpus=2,
                 RDZV_PORT=str(_free_port()), OMP_NUM_THREADS="1")
    snap = tmp_path / "snap.pt"
    proc = subprocess.run(
        ["bash", SCRIPT, "--device", "cpu", "--dist-backend", "gloo",
         "--config", os.path.join(REPO, "gpt2_config.yaml"),
         "gpt_config.model_type=gpt-nano", "~gpt_config.n_layer",
         "~gpt_config.n_head", "~gpt_config.n_embd", "gpt_config.dtype=float32",
         "gpt_config.attn_pdrop=0",
         f"data_config.path={os.path.join(REPO, 'data', 'input.txt')}",
         "data_config.block_size=32", "data_config.truncate=0.05",
         "trainer_config.batch_size=8", "trainer_config.max_steps=2",
         "trainer_config.log_every=1", "trainer_config.eval_batches=1",
         f"trainer_config.snapshot_path={snap}"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    steps = [line for line in proc.stdout.splitlines() if line.startswith("step ")]
    assert [s.split(" |")[0] for s in steps] == ["step 1", "step 2"], proc.stdout
    assert os.path.exists(f"{snap}.manifest.json")
    # the agent's INFO log (LOGLEVEL): both ranks in one group, both done
    assert "global_world_sizes=[2, 2]" in proc.stderr
    assert "WorkerState.SUCCEEDED" in proc.stderr
