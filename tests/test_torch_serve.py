"""The port's serving tier (``blendjax_torch.serve``) on the CPU, held to
``tests/test_serve.py``'s cases that need no MoE or watchdog, and to the
JAX package over the wire: each package's ``ServeClient`` against the
other's ``PolicyServer`` (upgraded to ShmRPC), and a snapshot the JAX
package published adopted by the port's server.  Every server runs through ``start_server_thread``
(or as ``python -m blendjax_torch.serve.server``), every client with a
timeout.

Tolerances: served predictions within 1e-5 (absolute, plus 1e-5 relative)
of the JAX package's serial decode or server, f32 end to end; the linear
model's exactly; int8 against float within the reference's 5% of the
output scale on a trained model.
"""

import functools
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blendjax.models import policy as jpol
from blendjax.models import seqformer as jseq
from blendjax_torch.btt import shm_rpc
from blendjax_torch.btt.faults import FaultPolicy
from blendjax_torch.models import seqformer as tseq
from blendjax_torch.models.convert import params_from_jax
from blendjax_torch.models.train import TrainState, make_train_step
from blendjax_torch.obs.spans import SpanRecorder, span_trace
from blendjax_torch.serve import (
    LinearModel,
    PolicyModel,
    SeqFormerModel,
    ServeClient,
    start_server_thread,
)
from blendjax_torch.utils.timing import SERVE_EVENTS, SERVE_STAGES, EventCounters, StageTimer
from helpers.time_limit import time_limit

REPO = Path(__file__).resolve().parent.parent
NO_RETRY = FaultPolicy(max_retries=0)

#: tests/test_serve.py's decode matrix
CASES = {
    "learned": (dict(), None),
    "learned-windowed": (dict(), 4),
    "rope": (dict(pos_encoding="rope"), None),
    "rope-windowed": (dict(pos_encoding="rope"), 4),
    "gqa": (dict(n_kv_heads=2), None),
    # the server decodes an MoE model with decode_step's defaults: the dense mixture
    "moe": (dict(n_experts=4), None),
}


def _serve_counts(counters):
    return {k: v for k, v in counters.snapshot().items() if k.startswith("serve_")}


def _params(**kw):
    tree = jax.device_get(jseq.init(jax.random.PRNGKey(0), obs_dim=5, d_model=32,
                                    n_heads=4, n_layers=2, max_len=32, **kw))
    return tree, params_from_jax(tree, device="cpu")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5, rtol=1e-5)


def _jax_serial(tree, episodes, length, window):
    """The reference's per-episode scalar-position decode."""
    step = jax.jit(functools.partial(jseq.decode_step, compute_dtype=jnp.float32,
                                     window=window))
    out = []
    for ep in episodes:
        cache = jseq.init_cache(tree, 1, dtype=jnp.float32, length=length)
        preds = []
        for t in range(len(ep)):
            p, cache = step(tree, cache, jnp.asarray(ep[t][None]))
            preds.append(np.asarray(p[0]))
        out.append(np.stack(preds))
    return out


def _episodes(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((t, 5)).astype(np.float32) for t in lengths]


# ---------------------------------------------------------------------------
# the SeqFormer adapter: per-row decode and prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_per_row_decode_matches_per_episode_serial(case):
    """The served tick (gather -> per-row ``decode_step`` -> scatter, padded
    to a bucket onto the pad row) over episodes at heterogeneous lengths
    equals each episode's serial decode in the reference."""
    kw, window = CASES[case]
    tree, params = _params(**kw)
    episodes = _episodes(0, (7, 3, 5, 1))
    length = 16 if window is None else window
    want = _jax_serial(tree, episodes, length, window)
    model = SeqFormerModel(params, slots=4, length=length, window=window)
    got = [[] for _ in episodes]
    for t in range(7):
        live = [i for i, ep in enumerate(episodes) if t < len(ep)]
        idx = np.full(4, model.pad_slot, np.int64)
        obs = np.zeros((4, 5), np.float32)
        idx[:len(live)] = live
        obs[:len(live)] = [episodes[i][t] for i in live]
        pred = model.step_rows(idx, obs)
        for j, i in enumerate(live):
            got[i].append(pred[j])
    for g, w in zip(got, want):
        _close(np.stack(g), w)


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_admission_matches_serial_decode(case):
    """One teacher-forced prefill pass leaves the slot where T serial
    decode steps would: the prefill's prediction is the T'th serial one,
    and every later step decodes identically."""
    kw, window = CASES[case]
    tree, params = _params(**kw)
    ep = np.random.default_rng(2).standard_normal((9, 5)).astype(np.float32)
    t0 = 5
    want = _jax_serial(tree, [ep], 16, window)[0]
    model = SeqFormerModel(params, slots=3, length=16, window=window)
    _close(model.prefill_rows(np.asarray([1]), ep[:t0]), want[t0 - 1])
    for t in range(t0, len(ep)):
        _close(model.step_rows(np.asarray([1]), ep[t][None])[0], want[t])


def test_prefill_reset_end_to_end_and_validation():
    counters = EventCounters()
    with start_server_thread(LinearModel(obs_dim=4, slots=1, seed=0),
                             counters=counters) as h:
        c = ServeClient(h.address, fault_policy=NO_RETRY)
        prefix = np.random.default_rng(1).standard_normal((5, 4)).astype(np.float32)
        ref = LinearModel(obs_dim=4, slots=1, seed=0)
        reply = c.reset(prefix=prefix)
        assert reply["pos"] == 5
        np.testing.assert_allclose(reply["pred"], ref.prefill_rows(np.asarray([0]), prefix))
        assert c.step(prefix[0])["pos"] == 5
        assert c.close_episode()
        # a bad prefix shape errors and releases the (only) slot
        with pytest.raises(RuntimeError, match="prefix shape"):
            c.reset(prefix=np.zeros((3, 9), np.float32))
        c.reset(prefix=prefix)
        assert c.close_episode()
        assert _serve_counts(counters)["serve_prefills"] == 2
        c.close()
    params = params_from_jax(jax.device_get(jpol.init(jax.random.PRNGKey(0), 4, 3)),
                             device="cpu")
    with start_server_thread(PolicyModel(params, 4)) as h:
        c = ServeClient(h.address, fault_policy=NO_RETRY)
        with pytest.raises(RuntimeError, match="stateless"):
            c.reset(prefix=np.zeros((3, 4), np.float32))
        c.close()


# ---------------------------------------------------------------------------
# the server: routing, counters, slots
# ---------------------------------------------------------------------------


def test_multi_model_server_per_model_pools_and_routing():
    obs = np.arange(4, dtype=np.float32)
    with start_server_thread({"a": LinearModel(obs_dim=4, slots=1, seed=0),
                              "b": LinearModel(obs_dim=4, slots=2, seed=7)}) as h:
        ca = ServeClient(h.address, model="a", fault_policy=NO_RETRY)
        cb = ServeClient(h.address, model="b", fault_policy=NO_RETRY)
        assert set(ca.hello()["models"]) == {"a", "b"}
        ca.reset()
        cb.reset()
        np.testing.assert_allclose(ca.step(obs)["pred"], obs @ LinearModel(4, slots=1).w)
        np.testing.assert_allclose(cb.step(obs)["pred"],
                                   obs @ LinearModel(4, slots=2, seed=7).w)
        ca2 = ServeClient(h.address, model="a", fault_policy=NO_RETRY)
        with pytest.raises(RuntimeError, match="no free episode slot"):
            ca2.reset()
        cb2 = ServeClient(h.address, model="b")
        cb2.reset()
        bogus = ServeClient(h.address, model="nope", fault_policy=NO_RETRY)
        with pytest.raises(RuntimeError, match="unknown model"):
            bogus.reset()
        for c in (ca, cb, ca2, cb2, bogus):
            c.close()


def test_multi_model_single_workload_replies_identical():
    def run_workload(address):
        c = ServeClient(address)
        obs = np.linspace(-1, 1, 4).astype(np.float32)
        out = [("hello", c.hello())]
        c.reset()
        out.append(("reset", {"slot": c.slot, "episode": c.episode}))
        out.extend(("step", c.step(obs + t)) for t in range(3))
        out.append(("close", {"closed": c.close_episode()}))
        c.close()
        return out

    with start_server_thread(LinearModel(obs_dim=4, slots=2, seed=0)) as h:
        single = run_workload(h.address)
    with start_server_thread({"linear": LinearModel(obs_dim=4, slots=2, seed=0)}) as h:
        multi = run_workload(h.address)
    assert len(single) == len(multi)
    for (ks, vs), (km, vm) in zip(single, multi):
        assert ks == km and set(vs) == set(vm)
        for key in vs:
            if isinstance(vs[key], np.ndarray):
                assert vs[key].tobytes() == vm[key].tobytes(), (ks, key)
            elif key not in ("pid", "shm"):
                # the pid and the shm endpoint are the server process's own
                assert vs[key] == vm[key], (ks, key)


def test_linear_server_end_to_end_counters_and_stages():
    counters, timer, spans = EventCounters(), StageTimer(), SpanRecorder()
    with start_server_thread(LinearModel(obs_dim=4, slots=2, seed=0),
                             counters=counters, timer=timer) as h:
        c = ServeClient(h.address, span_recorder=spans)
        hello = c.hello()
        assert hello["model"] == "linear" and hello["slots"] == 2
        # the ShmRPC capability blob: the endpoint under the server's base
        assert hello["shm"]["endpoint"] == h.server.shm_endpoint
        assert hello["shm"]["host"] == shm_rpc.host_token()
        c.reset()
        obs = np.arange(4, dtype=np.float32)
        r0, r1 = c.step(obs), c.step(obs)
        assert (r0["pos"], r1["pos"]) == (0, 1)
        np.testing.assert_allclose(r1["pred"], r0["pred"] + 1.0)
        c2 = ServeClient(h.address, fault_policy=NO_RETRY)
        c2.reset()
        with pytest.raises(RuntimeError, match="no free episode slot"):
            c2.rpc("reset")
        assert c.close_episode()
        c2.rpc("reset")
        with pytest.raises(RuntimeError, match="unknown episode slot"):
            c2.step(obs, slot=99)
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            snap = _serve_counts(counters)
            if snap["serve_requests"] == (snap["serve_replies"]
                                          + snap.get("serve_dup_inflight", 0)):
                break
            time.sleep(0.01)
        assert snap["serve_slot_denied"] == 1
        assert snap["serve_errors"] >= 2
        assert snap["serve_resets"] == 3
        assert snap["serve_batches"] >= 2
        assert snap["serve_requests"] == (snap["serve_replies"]
                                          + snap.get("serve_dup_inflight", 0))
        assert set(snap) <= set(SERVE_EVENTS)
        summary = timer.summary()
        for stage in SERVE_STAGES:
            assert summary[stage]["count"] > 0, stage
        tel = c.telemetry()
        assert tel["counters"]["serve_batches"] >= 2 and "compute" in tel["stages"]
        c.close()
        c2.close()
    # server- and client-side spans of one RPC share the trace id
    srv = [s for s in spans.snapshot() if s["name"] == "serve:step"]
    cli = [s for s in spans.snapshot() if s["name"] == "serve_rpc:step"]
    assert srv and cli and span_trace(srv[0]) == span_trace(cli[0]) is not None


def test_slot_ttl_eviction():
    counters = EventCounters()
    with start_server_thread(LinearModel(obs_dim=4, slots=1, seed=0), counters=counters,
                             slot_ttl_s=0.2) as h:
        c1 = ServeClient(h.address)
        c1.reset()
        time.sleep(0.3)
        c2 = ServeClient(h.address)
        c2.reset()
        assert _serve_counts(counters)["serve_evictions"] == 1
        with pytest.raises(RuntimeError, match="stale episode lease"):
            c1.step(np.zeros(4, np.float32))
        assert not c1.close_episode()
        c2.step(np.zeros(4, np.float32))
        c1.close()
        c2.close()


def _run_episodes(address, episodes, client_cls=ServeClient, prefix_len=0, transports=None):
    """Each episode from its own client thread; returns each one's
    predictions (after the prefix: the prefill's, then every step's).
    ``transports`` (a list) collects each client's wire at its end."""
    outs = [[] for _ in episodes]
    errors = []

    def run(i):
        try:
            c = client_cls(address, timeoutms=20000)
            ep = episodes[i]
            if prefix_len:
                outs[i].append(c.reset(prefix=ep[:prefix_len])["pred"])
            else:
                c.reset()
            for t in range(prefix_len, len(ep)):
                outs[i].append(c.step(ep[t])["pred"])
            c.close_episode()
            if transports is not None:
                transports.append(c.transport)
            c.close()
        except Exception as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(episodes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    return [np.stack(o) for o in outs]


def test_seqformer_server_concurrent_episodes_match_serial():
    tree, params = _params()
    episodes = _episodes(1, (6, 3, 5))
    want = _jax_serial(tree, episodes, 16, None)
    counters = EventCounters()
    with start_server_thread(SeqFormerModel(params, slots=4, length=16),
                             counters=counters) as h:
        got = _run_episodes(h.address, episodes)
    for g, w in zip(got, want):
        _close(g, w)
    assert _serve_counts(counters)["serve_batches"] >= 3


def test_policy_server_stateless_greedy_logits():
    tree = jax.device_get(jpol.init(jax.random.PRNGKey(0), 6, 3))
    counters = EventCounters()
    with start_server_thread(PolicyModel(params_from_jax(tree, device="cpu"), 6),
                             counters=counters) as h:
        c = ServeClient(h.address)
        assert c.hello()["slots"] == 0
        assert c.reset() == -1
        obs = np.linspace(-1, 1, 6).astype(np.float32)
        _close(c.step(obs)["pred"], np.asarray(jpol.logits(tree, obs[None]))[0])
        assert c.stats()["live_episodes"] == 1
        assert c.close_episode()
        stale = ServeClient(h.address)
        stale.slot, stale.episode = -1, 999
        assert not stale.close_episode()
        snap = _serve_counts(counters)
        assert snap["serve_closes"] == 1 == snap["serve_resets"]
        stale.close()
        c.close()


def _trained_seqformer(steps=20):
    """A SeqFormer trained a little (random weights overstate quantization
    error): Adam(1e-2), f32, on a fixed batch."""
    params = tseq.init(torch.Generator().manual_seed(0), obs_dim=5, d_model=32,
                       n_heads=4, n_layers=2, max_len=32, device="cpu")
    episode = torch.randn((4, 17, 5), generator=torch.Generator().manual_seed(9))
    batch = tseq.make_episode_batch(episode)
    state = TrainState.create(params, lr=1e-2)
    step = make_train_step(
        lambda p, b: tseq.loss_fn(p, b, compute_dtype=torch.float32))
    for _ in range(steps):
        state, _ = step(state, batch)
    return {k: v.detach() for k, v in state.params.items()}


def test_int8_served_predictions_track_float():
    params = _trained_seqformer()
    ep = [np.random.default_rng(3).standard_normal((6, 5)).astype(np.float32)]

    def serve(model):
        with start_server_thread(model) as h:
            return _run_episodes(h.address, ep)[0]

    ref = serve(SeqFormerModel(params, slots=2, length=16))
    model = SeqFormerModel(params, slots=2, length=16, int8=True)
    assert model.params["blocks.0.wq.w_q"].dtype == torch.int8
    got = serve(model)
    err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert err < 0.05 * max(scale, 1.0), (err, scale)


def test_malformed_requests_error_but_server_survives():
    import zmq

    counters = EventCounters()
    with start_server_thread(LinearModel(obs_dim=4, slots=2, seed=0),
                             counters=counters) as h:
        c = ServeClient(h.address, fault_policy=NO_RETRY)
        c.reset()
        with pytest.raises(RuntimeError, match="unknown serve command"):
            c.rpc("frobnicate")
        with pytest.raises(RuntimeError, match="obs"):
            c.rpc("step", {"slot": c.slot, "episode": c.episode})
        with pytest.raises(RuntimeError, match="obs shape"):
            c.rpc("step", {"slot": c.slot, "episode": c.episode,
                           "obs": np.zeros(7, np.float32)}, raw_buffers=True)
        assert c.step(np.zeros(4, np.float32))["pos"] == 0
        assert _serve_counts(counters)["serve_errors"] == 3
        rogue = zmq.Context.instance().socket(zmq.DEALER)
        rogue.setsockopt(zmq.LINGER, 0)
        rogue.connect(h.address)
        rogue.send_multipart([b"", b"not-pickle-at-all"])
        rogue.close(0)
        assert c.step(np.zeros(4, np.float32))["pos"] == 1
        c.close()


@pytest.mark.chaos
def test_exactly_once_through_drop_dup_and_stall():
    """TCP-level faults between the port's client and server (the JAX
    package's ``ChaosProxy``) each yield exactly one applied step per
    request: the linear model's position rides every prediction."""
    from blendjax.btt.chaos import ChaosProxy

    counters = EventCounters()
    ref = LinearModel(obs_dim=4, slots=2, seed=0)
    obs = np.arange(4, dtype=np.float32)
    with start_server_thread(LinearModel(obs_dim=4, slots=2, seed=0),
                             counters=counters) as h, ChaosProxy(h.address) as proxy:
        # pinned to ZMQ: the proxy injects at the TCP layer, which an
        # upgraded channel would leave (the shm arm is test_torch_shm_rpc's)
        client = ServeClient(
            proxy.address, counters=counters, timeoutms=400, shm=False,
            fault_policy=FaultPolicy(max_retries=4, backoff_base=0.02, backoff_max=0.1,
                                     circuit_threshold=0, seed=1))
        client.reset()
        ref.reset_rows(np.asarray([0]))
        preds = []
        for t in range(20):
            if t == 5:
                proxy.drop_next("down")   # lose a reply -> retry
            if t == 9:
                proxy.dup_next("up")      # duplicate a request
            if t == 13:
                proxy.stall()

                def unstall():
                    time.sleep(0.6)  # past the 400 ms attempt
                    proxy.resume()

                threading.Thread(target=unstall, daemon=True).start()
            preds.append(client.step(obs)["pred"])
        want = [ref.step_rows(np.asarray([0]), obs[None])[0] for _ in range(20)]
        np.testing.assert_allclose(np.stack(preds), np.stack(want))
        snap = counters.snapshot()
        assert snap.get("retries", 0) >= 2
        assert snap.get("serve_cache_hits", 0) + snap.get("serve_dup_inflight", 0) >= 1
        client.close()


# ---------------------------------------------------------------------------
# the two packages over the wire
# ---------------------------------------------------------------------------


def test_jax_client_against_port_server():
    """The JAX package's ``ServeClient`` drives the port's server and
    upgrades to the port's ShmRPC rings: concurrent episodes, the first
    admitted with a prefix, equal the reference's serial decode."""
    from blendjax.serve import ServeClient as JaxClient

    tree, params = _params(pos_encoding="rope")
    episodes = _episodes(4, (8, 5, 6))
    want = _jax_serial(tree, episodes, 16, None)
    transports, counters = [], EventCounters()
    with start_server_thread(SeqFormerModel(params, slots=4, length=16),
                             counters=counters) as h:
        got = _run_episodes(h.address, episodes, client_cls=JaxClient, transports=transports)
        got_prefix = _run_episodes(h.address, episodes[:1], client_cls=JaxClient,
                                   prefix_len=3, transports=transports)[0]
    for g, w in zip(got, want):
        _close(g, w)
    _close(got_prefix, want[0][2:])
    assert transports == ["shm"] * 4
    assert counters.get("serve_shm_bytes") > 0


def test_port_client_against_jax_server():
    from blendjax.serve import SeqFormerModel as JaxSeqFormerModel
    from blendjax.serve import start_server_thread as jax_start

    tree, params = _params()
    episodes = _episodes(5, (7, 4))
    with jax_start(JaxSeqFormerModel(jax.tree.map(jnp.asarray, tree), slots=4,
                                     length=16)) as h:
        want = _run_episodes(h.address, episodes)
        want_prefix = _run_episodes(h.address, episodes[:1], prefix_len=4)[0]
    with start_server_thread(SeqFormerModel(params, slots=4, length=16)) as h:
        got = _run_episodes(h.address, episodes)
    for g, w in zip(got, want):
        _close(g, w)
    _close(want_prefix, want[0][3:])


@pytest.mark.parametrize("int8", [False, True])
def test_jax_snapshot_adopted_by_port_server(int8):
    """A snapshot the JAX package's ``snapshot_messages`` produced, sent
    over the wire and assembled by the port, is adopted through
    ``apply_weights``: the port's server then answers as the JAX server
    holding those weights.  A snapshot of the other precision is refused
    and the served weights stay."""
    from blendjax.ops.quant import quantize_seqformer
    from blendjax.serve import SeqFormerModel as JaxSeqFormerModel
    from blendjax.weights.snapshot import Snapshot as JaxSnapshot
    from blendjax.weights.snapshot import snapshot_messages
    from blendjax_torch import wire
    from blendjax_torch.weights import SnapshotAssembler

    _, params = _params()
    new_tree = jax.device_get(jseq.init(jax.random.PRNGKey(7), obs_dim=5, d_model=32,
                                        n_heads=4, n_layers=2, max_len=32))
    published = jax.device_get(quantize_seqformer(new_tree)) if int8 else new_tree
    asm = SnapshotAssembler()
    snap = None
    for msg in snapshot_messages(JaxSnapshot.from_params(published, version=3),
                                 chunk_bytes=4096):
        # each message crosses the wire encoding as the bus would send it
        frames = [bytes(f) for f in wire.encode(msg, raw_buffers=True)]
        done, reason = asm.feed(wire.decode(frames))
        assert reason is None
        snap = done or snap
    assert snap is not None and snap.version == 3
    model = SeqFormerModel(params, slots=2, length=16, int8=int8)
    model.apply_weights(snap.tree())
    other = new_tree if int8 else jax.device_get(quantize_seqformer(new_tree))
    before = {k: v.clone() for k, v in model.params.items()}
    with pytest.raises(ValueError, match="precision"):
        model.apply_weights(other)
    assert all(torch.equal(before[k], model.params[k]) for k in before)
    episodes = _episodes(6, (6,))
    with start_server_thread(model) as h:
        got = _run_episodes(h.address, episodes)[0]
    from blendjax.serve import start_server_thread as jax_start

    with jax_start(JaxSeqFormerModel(jax.tree.map(jnp.asarray, new_tree), slots=2,
                                     length=16, int8=int8)) as h:
        want = _run_episodes(h.address, episodes)[0]
    _close(got, want)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_server_process_on_cpu_serves_the_jax_client():
    """``python -m blendjax_torch.serve.server --model seqformer --device
    cpu`` serves the JAX package's client: its params are seeded, so a
    same-seed model in this process predicts what it answers."""
    from blendjax.serve import ServeClient as JaxClient

    address = f"tcp://127.0.0.1:{_free_port()}"
    argv = ["--address", address, "--model", "seqformer", "--device", "cpu", "--seed", "3",
            "--obs-dim", "5", "--slots", "2", "--length", "16", "--d-model", "32"]
    proc = subprocess.Popen([sys.executable, "-m", "blendjax_torch.serve.server", *argv],
                            cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        client = JaxClient(address, timeoutms=30000)
        client.hello()
        ep = _episodes(7, (4,))
        got = _run_episodes(address, ep, client_cls=JaxClient)[0]
        client.close()
    finally:
        proc.terminate()
        proc.wait(timeout=20)
    params = tseq.init(torch.Generator().manual_seed(3), obs_dim=5, d_model=32, n_heads=4,
                       n_layers=2, max_len=16, device="cpu")
    model = SeqFormerModel(params, slots=2, length=16)
    want = np.stack([model.step_rows(np.asarray([0]), o[None])[0] for o in ep[0]])
    _close(got, want)


@time_limit(120)
def test_server_process_and_fleet_boot_respawn_grow_retire():
    """``ServerProcess`` and ``ServerFleet`` on the CPU: replicas boot and
    answer ``hello``, a SIGKILLed replica respawns under the watchdog's
    call with its command line (and answers again), ``grow`` appends with
    stable indices, and ``retire`` leaves a slot that is never respawned."""
    from blendjax_torch.btt.chaos import kill_instance
    from blendjax_torch.btt.shm_rpc import leaked_objects
    from blendjax_torch.serve import ServerFleet, ServerProcess

    with ServerProcess(model="linear", obs_dim=4, slots=2, device="cpu") as sp:
        assert ServeClient(sp.address, timeoutms=10000).hello()["obs_dim"] == 4
    with ServerFleet(2, model="linear", obs_dim=4, slots=2, device="cpu") as fleet:
        addrs = list(fleet.addresses)
        pids = [ServeClient(a, timeoutms=10000).hello()["pid"] for a in addrs]
        assert len(set(pids)) == 2
        kill_instance(fleet, 1)
        fleet.launch_info.processes[1].wait(timeout=10)
        fleet.respawn(1)
        fleet._procs[1].wait_ready(30)
        assert ServeClient(addrs[1], timeoutms=10000).hello()["pid"] not in pids
        [(idx, addr)] = fleet.grow(1)
        assert idx == 2 and fleet.addresses == addrs + [addr]
        assert ServeClient(addr, timeoutms=10000).hello()["obs_dim"] == 4
        assert fleet.retire(1) is True and fleet.retire(1) is False
        assert fleet.addresses == [addrs[0], None, addr]
        assert fleet.launch_info.processes[1] is None
        with pytest.raises(RuntimeError, match="retired"):
            fleet.respawn(1)
        bases = [p.shm_base for p in fleet._procs if p is not None]
    for base in bases:
        if base is not None:
            assert not leaked_objects(base)


def test_warm_touches_only_the_pad_row():
    """``SeqFormerModel.warm`` (the server's, for a captured model) runs every bucket's
    tick on the pad row: a live episode's predictions and positions are
    those of a model that was never warmed."""
    tree, params = _params()
    obs = _episodes(3, (6,))[0]
    cold = SeqFormerModel(params, slots=4, length=16)
    warm = SeqFormerModel({k: v.clone() for k, v in params.items()}, slots=4, length=16)
    for m in (cold, warm):
        m.reset_rows(np.asarray([1]))
        m.step_rows(np.asarray([1]), obs[:1])
    warm.warm((1, 2, 4))
    for t in range(1, len(obs)):
        np.testing.assert_array_equal(warm.step_rows(np.asarray([1]), obs[t:t + 1]),
                                      cold.step_rows(np.asarray([1]), obs[t:t + 1]))
    assert torch.equal(warm._cache["pos"][:warm.pad_slot], cold._cache["pos"][:cold.pad_slot])


@time_limit(120)
def test_server_process_on_the_card_does_not_fall_back_to_the_cpu():
    """A replica asked for the card (the default) runs there or fails its
    ``wait_ready`` with the child's own error: it never serves from the
    CPU."""
    from blendjax_torch.serve import ServerProcess

    sp = ServerProcess(model="linear", obs_dim=4, slots=2)
    assert "--device" in sp._cmd and sp._cmd[sp._cmd.index("--device") + 1] == "cuda"
    if torch.cuda.is_available():
        with sp:
            assert ServeClient(sp.address, timeoutms=10000).hello()["obs_dim"] == 4
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            with sp:
                pass


def test_subscriber_and_subscribe_flag_adopt_published_weights():
    """``PolicyServer(subscriber=)`` in process and ``--subscribe`` on the
    server process: a published linear tree is adopted between ticks and
    the next replies carry its version and its weights (exact up to f32)."""
    from blendjax_torch.weights import WeightPublisher, WeightSubscriber, linear_tree

    obs = np.arange(8, dtype=np.float32)
    with WeightPublisher(version_base=40).start() as pub:
        v = pub.publish(linear_tree(41, 8))
        w = linear_tree(41, 8)["w"]
        with start_server_thread(LinearModel(obs_dim=8, slots=2),
                                 subscriber=WeightSubscriber(pub.address)) as h:
            deadline = time.monotonic() + 10
            while h.server.weight_version != v and time.monotonic() < deadline:
                time.sleep(0.02)
            c = ServeClient(h.address, timeoutms=5000)
            c.reset()
            r = c.step(obs)
            assert r["weight_version"] == v == c.weight_version
            np.testing.assert_allclose(r["pred"], obs @ w, rtol=1e-6)
            c.close()
        address = f"tcp://127.0.0.1:{_free_port()}"
        proc = subprocess.Popen([sys.executable, "-m", "blendjax_torch.serve.server",
                                 "--address", address, "--model", "linear", "--device", "cpu",
                                 "--obs-dim", "8", "--subscribe", pub.address], cwd=REPO)
        try:
            c = ServeClient(address, timeoutms=20000)
            c.reset()
            deadline = time.monotonic() + 30
            r = c.step(obs)
            while r.get("weight_version") != v and time.monotonic() < deadline:
                r = c.step(obs)
            assert r["weight_version"] == v
            np.testing.assert_allclose(r["pred"], obs @ w + np.float32(r["pos"]), rtol=1e-6)
            c.close()
        finally:
            proc.terminate()
            proc.wait(timeout=30)


def test_shm_base_flag_names_the_server_prefix():
    """``--shm-base`` puts every ShmRPC object of the server process under
    the given prefix: ``hello`` advertises it, a client's channel lives
    under it, and nothing is left there once the server exits."""
    base = shm_rpc.new_base("t")
    address = f"tcp://127.0.0.1:{_free_port()}"
    proc = subprocess.Popen([sys.executable, "-m", "blendjax_torch.serve.server", "--address",
                             address, "--device", "cpu", "--shm-base", base],
                            cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        client = ServeClient(address, timeoutms=30000)
        assert client.hello()["shm"]["endpoint"] == f"shm://{base}"
        client.reset()
        client.step(np.zeros(8, np.float32))
        assert client.transport == "shm"
        assert any(".c2s" in p for p in shm_rpc.leaked_objects(base))
        client.close()
    finally:
        proc.terminate()
        proc.wait(timeout=20)
    assert shm_rpc.leaked_objects(base) == []
