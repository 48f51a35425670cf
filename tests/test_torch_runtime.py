"""The port's own runtime core against the JAX package's, on the CPU.

The same user programs run under `ray_tpu` and under `ray_tpu_torch`, one
runtime after the other (never both at once: they share the RT_*
environment names and each keeps module-global state), each started once
for the module with `init(num_cpus=4)`. Each program is a function of the
runtime module and one parametrised case: its results must be equal, and
where it raises, the exception class must have the same name in both.

The programs cover put/get of nested values and a 4 MB numpy array,
kwargs and ref arguments, nested tasks, num_returns, wait and get with
timeouts, a task's error and its cause, max_retries over a worker that dies
once (a marker file), actor state and call order, named actors, kill,
max_restarts, a streaming generator, refs inside containers, cancel of a
task waiting on its argument, a
STRICT_PACK placement group and cluster_resources.
"""

import os
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch

PROGRAMS = {}


def program(fn):
    PROGRAMS[fn.__name__] = fn
    return fn


@program
def put_get_nested(rt, tmp):
    value = {"a": [1, (2, 3.5)], "b": {"c": None, "d": b"\x00\xff"},
             "s": "text", "set": {4, 5}}
    return rt.get(rt.put(value))


@program
def put_get_numpy_4mb(rt, tmp):
    arr = np.arange(1 << 19, dtype=np.float64)  # 4 MiB
    got = rt.get(rt.put(arr))
    return got.dtype.str, got.shape, bool(np.array_equal(got, arr))


@program
def numpy_through_a_task(rt, tmp):
    @rt.remote
    def total(a, scale=1.0):
        return float(a.sum() * scale), a.dtype.str, a.shape

    arr = np.ones((512, 1024), dtype=np.float32)  # 2 MiB: through the store
    return rt.get(total.remote(rt.put(arr), scale=0.5))


@program
def kwargs_and_ref_arguments(rt, tmp):
    @rt.remote
    def combine(a, b, *, c=0, d=0):
        return [a, b, c, d]

    ra, rd = rt.put(10), rt.put({"k": 4})
    return rt.get(combine.remote(ra, 2, c=rt.put(3), d=rd))


@program
def nested_tasks(rt, tmp):
    @rt.remote
    def leaf(x):
        return x * x

    @rt.remote
    def parent(n):
        return sum(rt.get([leaf.remote(i) for i in range(n)]))

    return rt.get(parent.remote(5))


@program
def num_returns(rt, tmp):
    @rt.remote(num_returns=3)
    def three():
        return "a", ["b"], {"c": 1}

    refs = three.remote()
    return len(refs), rt.get(list(refs))


# The slow tasks hold no CPU, so they leave the node's four to the
# programs that follow until shutdown takes their workers.
@program
def wait_with_num_returns(rt, tmp):
    # two functions: tasks of one function may queue on one worker's lease
    @rt.remote(num_cpus=0)
    def quick(i):
        return i

    @rt.remote(num_cpus=0)
    def slow():
        time.sleep(30)

    refs = [quick.remote(i) for i in range(3)] + [slow.remote()]
    ready, pending = rt.wait(refs, num_returns=3, timeout=20)
    return len(ready), len(pending), sorted(rt.get(ready))


@program
def wait_timeout(rt, tmp):
    @rt.remote(num_cpus=0)
    def forever():
        time.sleep(30)

    ready, pending = rt.wait([forever.remote()], num_returns=1, timeout=0.2)
    return len(ready), len(pending)


@program
def get_timeout(rt, tmp):
    @rt.remote(num_cpus=0)
    def forever():
        time.sleep(30)

    rt.get(forever.remote(), timeout=0.2)


@program
def task_error_type_and_cause(rt, tmp):
    @rt.remote
    def boom(x):
        raise KeyError(f"missing {x}")

    try:
        rt.get(boom.remote(7))
    except Exception as err:  # noqa: BLE001 — the class is the result
        cause = getattr(err, "cause", None)
        return (type(err).__name__, isinstance(err, KeyError),
                isinstance(err, rt.exceptions.RayTaskError),
                type(cause).__name__, str(cause))
    return None


@program
def task_error_raises(rt, tmp):
    @rt.remote
    def boom():
        raise ValueError("boom")

    rt.get(boom.remote())


@program
def max_retries_after_a_worker_death(rt, tmp):
    marker = os.path.join(tmp, f"died-once-{rt.__name__}")

    @rt.remote(max_retries=2)
    def flaky():
        if not os.path.exists(marker):
            open(marker, "w").close()
            os._exit(1)
        return "second attempt"

    return rt.get(flaky.remote(), timeout=60), os.path.exists(marker)


@program
def no_retries_surfaces_the_death(rt, tmp):
    @rt.remote(max_retries=0)
    def dies():
        os._exit(1)

    rt.get(dies.remote(), timeout=60)


@program
def actor_state_and_call_order(rt, tmp):
    @rt.remote
    class Log:
        def __init__(self, first):
            self.items = [first]

        def add(self, x):
            self.items.append(x)
            return len(self.items)

        def items_(self):
            return self.items

    log = Log.remote("start")
    lengths = rt.get([log.add.remote(i) for i in range(20)])
    return lengths, rt.get(log.items_.remote())


@program
def named_actor_through_get_actor(rt, tmp):
    @rt.remote
    class Box:
        def __init__(self, v):
            self.v = v

        def get(self):
            return self.v

    box = Box.options(name="box", namespace="parity").remote(41)
    rt.get(box.get.remote())
    found = rt.get_actor("box", namespace="parity")
    value = rt.get(found.get.remote())
    rt.kill(box)
    return value


@program
def get_actor_of_a_missing_name(rt, tmp):
    rt.get_actor("no-such-actor", namespace="parity")


@program
def kill_then_call(rt, tmp):
    @rt.remote
    class Alive:
        def ping(self):
            return "pong"

    a = Alive.remote()
    pong = rt.get(a.ping.remote())
    rt.kill(a)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:  # a kill lands asynchronously
        try:
            rt.get(a.ping.remote(), timeout=30)
        except Exception as err:  # noqa: BLE001 — the class is the result
            # ActorDiedError or its base, as the death notice races the call
            return pong, isinstance(err, rt.exceptions.RayActorError)
        time.sleep(0.05)
    return pong, None


@program
def max_restarts(rt, tmp):
    @rt.remote(max_restarts=1, max_task_retries=0)
    class Phoenix:
        def __init__(self):
            self.calls = 0

        def count(self):
            self.calls += 1
            return self.calls

        def die(self):
            os._exit(1)

    p = Phoenix.remote()
    before = rt.get([p.count.remote(), p.count.remote()])
    try:
        rt.get(p.die.remote(), timeout=60)
        died = None
    except Exception as err:  # noqa: BLE001 — the class is the result
        died = type(err).__name__
    deadline = time.monotonic() + 60
    while True:  # the restarted actor starts from its constructor again
        try:
            after = rt.get(p.count.remote(), timeout=30)
            break
        except Exception:  # noqa: BLE001 — still restarting
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)
    return before, died, after


@program
def streaming_generator(rt, tmp):
    @rt.remote(num_returns="streaming")
    def count_to(n):
        for i in range(n):
            yield {"i": i, "sq": i * i}

    return [rt.get(ref) for ref in count_to.remote(5)]


@program
def refs_inside_containers(rt, tmp):
    @rt.remote
    def make():
        return [rt.put(i * 10) for i in range(3)]

    @rt.remote
    def read(box):
        return [rt.get(r) for r in box["refs"]]

    refs = rt.get(make.remote())  # borrowed from the worker that put them
    return rt.get(read.remote({"refs": refs})), rt.get(refs)


@program
def cancel_a_task_waiting_on_its_argument(rt, tmp):
    @rt.remote(num_cpus=0)
    def slow():
        time.sleep(5)
        return 1

    @rt.remote
    def consume(x):
        return x

    ref = consume.remote(slow.remote())
    time.sleep(0.2)  # the consumer parks on its pending argument
    rt.cancel(ref)
    rt.get(ref, timeout=10)


@program
def strict_pack_placement_group(rt, tmp):
    pg_mod = __import__(f"{rt.__name__}.util.placement_group",
                        fromlist=["placement_group"])
    strategies = __import__(f"{rt.__name__}.util.scheduling_strategies",
                            fromlist=["PlacementGroupSchedulingStrategy"])
    pg = pg_mod.placement_group([{"CPU": 1}, {"CPU": 1}],
                                strategy="STRICT_PACK")
    ready = rt.get(pg.ready(), timeout=30)

    @rt.remote(num_cpus=1)
    def where():
        ctx = rt.get_runtime_context()
        return ctx.get_placement_group_id() is not None

    inside = rt.get(where.options(
        scheduling_strategy=strategies.PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=1)).remote())
    pg_mod.remove_placement_group(pg)
    return ready is not None, inside


@program
def cluster_resources(rt, tmp):
    res = rt.cluster_resources()
    return {k: v for k, v in res.items() if k in ("CPU", "memory")}


@program
def runtime_context_in_a_task(rt, tmp):
    @rt.remote(num_cpus=2)
    def ctx():
        c = rt.get_runtime_context()
        return (c.get_assigned_resources(), c.get_actor_id() is None,
                len(c.get_job_id()) > 0)

    return rt.get(ctx.remote())


@program
def put_of_a_ref(rt, tmp):
    rt.put(rt.put(1))


@program
def actor_method_error(rt, tmp):
    @rt.remote
    class Faulty:
        def bad(self, x):
            return 1 / x

    f = Faulty.remote()
    try:
        rt.get(f.bad.remote(0))
    except Exception as err:  # noqa: BLE001 — the class is the result
        return type(err).__name__, isinstance(err, ZeroDivisionError)
    return None


def _run_all(rt, tmp):
    out = {}
    rt.init(num_cpus=4)
    try:
        for name, fn in PROGRAMS.items():
            try:
                out[name] = ("value", fn(rt, tmp))
            except Exception as err:  # noqa: BLE001 — the class is the result
                out[name] = ("raised", type(err).__name__)
    finally:
        rt.shutdown()
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("runtime_parity"))
    # one runtime after the other, never both at once
    return _run_all(ray_tpu, tmp), _run_all(ray_tpu_torch, tmp)


def test_there_are_twenty_programs_at_least():
    assert len(PROGRAMS) >= 20


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_the_same_program_gives_the_same_result(results, name):
    jax_rt, port = results
    assert port[name] == jax_rt[name]


def test_the_programs_that_raise(results):
    """The error programs raise in both, and the rest return."""
    _, port = results
    raised = {n for n, (kind, _) in port.items() if kind == "raised"}
    assert raised == {"get_timeout", "task_error_raises",
                      "no_retries_surfaces_the_death",
                      "get_actor_of_a_missing_name",
                      "cancel_a_task_waiting_on_its_argument",
                      "put_of_a_ref"}
    assert port["get_timeout"][1] == "GetTimeoutError"
    assert port["kill_then_call"][1] == ("pong", True)
    assert port["cancel_a_task_waiting_on_its_argument"][1] == (
        "TaskCancelledError")


def test_the_worker_stack_imports_no_torch():
    """A runtime worker (and the zygote it forks from) loads torch only
    when a task needs it, so a plain worker starts as fast as the JAX
    package's."""
    import subprocess
    import sys

    code = ("import sys; import ray_tpu_torch, "
            "ray_tpu_torch.worker.core_worker, "
            "ray_tpu_torch.worker.executor, "
            "ray_tpu_torch._private.workers.default_worker, "
            "ray_tpu_torch._private.workers.zygote, "
            "ray_tpu_torch.raylet.raylet, ray_tpu_torch.gcs.server; "
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.stdout.strip() == "False"


SESSION_PATHS = """
import json, os
import ray_tpu_torch as rt
from ray_tpu_torch._private import event_log
from ray_tpu_torch._private.config import CONFIG

rt.init(num_cpus=1)
try:
    @rt.remote
    def where():
        from ray_tpu_torch._private.config import CONFIG
        return CONFIG.log_dir, os.environ.get("RT_WORKER_LOG_PATH", "")

    ref = rt.put(b"x" * (1 << 20))  # into the node's shm store
    raylet = rt.api._global_node.raylet
    paths = {"log_dir": CONFIG.log_dir,
             "spill": CONFIG.object_store_fallback_dir,
             "flight": event_log.flight_dir(),
             "socket": raylet.store_socket or "",
             "worker_logs": raylet._log_dir}
    paths["worker_log_dir"], paths["worker_log"] = rt.get(where.remote())
    assert len(rt.get(ref)) == 1 << 20
finally:
    rt.shutdown()
print(json.dumps(paths))
"""


def test_a_session_writes_under_its_own_tmpdir(tmp_path):
    """The runtime's logs, store socket, spill directory and flight
    recorder lie in a directory of the session's own under TMPDIR, which
    its workers share, so two sessions on one host never meet."""
    import json
    import subprocess
    import sys

    tmpdir = tmp_path / "tmp"
    tmpdir.mkdir()
    env = dict(os.environ, TMPDIR=str(tmpdir))
    for name in [k for k in env if k.startswith("RT_")]:
        del env[name]
    out = subprocess.run([sys.executable, "-c", SESSION_PATHS], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-2000:]
    paths = json.loads(out.stdout.strip().splitlines()[-1])
    (session,) = os.listdir(tmpdir)
    assert session.startswith("rt_torch_session_")
    root = os.path.join(str(tmpdir), session)
    for key, path in paths.items():
        if key == "socket" and not path:
            continue  # no native store on this host
        assert path.startswith(root + os.sep), (key, path)
    assert paths["worker_log_dir"] == paths["log_dir"]
    assert os.path.dirname(paths["worker_log"]) == paths["worker_logs"]
    assert os.path.isfile(paths["worker_log"])
