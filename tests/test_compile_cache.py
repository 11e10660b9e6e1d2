"""cli.enable_compile_cache path rules: $JAX_COMPILATION_CACHE_DIR when set
(JAX reads it; the code sets no other path), otherwise one fixed directory
inside the checkout, whatever the working directory."""
import json
import os
import subprocess
import sys
import tempfile

from sep2023_tpu import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = ("import json, jax; from sep2023_tpu.cli import enable_compile_cache;"
         " p = enable_compile_cache();"
         " print(json.dumps([p, jax.config.jax_compilation_cache_dir]))")


def _probe(cwd, env_dir=None):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=cwd, env=env,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_default_cache_is_fixed_inside_checkout(tmp_path):
    path, configured = _probe(REPO)
    assert path == configured == cli.CACHE_DIR
    assert os.path.dirname(path) == REPO and os.path.isdir(path)
    assert not path.startswith(tempfile.gettempdir())


def test_default_cache_ignores_working_directory(tmp_path):
    assert _probe(str(tmp_path))[0] == _probe(REPO)[0] == cli.CACHE_DIR


def test_env_cache_dir_wins_and_no_other_path_is_set(tmp_path):
    env_dir = str(tmp_path / "jax-cache")
    path, configured = _probe(REPO, env_dir)
    assert path == configured == env_dir


def test_cache_dir_is_git_ignored():
    with open(os.path.join(REPO, ".gitignore")) as fp:
        ignored = {ln.strip() for ln in fp}
    assert os.path.basename(cli.CACHE_DIR) + "/" in ignored
