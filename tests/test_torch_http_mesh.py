"""``launch.serve --http`` on a multi-rank mesh, on the CPU: the front door
on rank 0 of four gloo ranks, every rank's router fed rank 0's ticks
(``router.frontdoor.EventRouter``). About 35 s serially.

HTTP clients post to rank 0 while ``serve.main(["--http", "--mesh",
"2x2", ...])`` runs; the same clients then post to the one-rank command
on the same seed. Greedy streams are equal, or part where both tokens lie
within ``NEAR_TIE`` of the best logit of the one-rank model's own forward
pass on the stream's prefix (bf16 sums in another order under "tp"), at
most a third of them; every rank's report is the same, and only rank 0
binds the port.
"""
import asyncio
import json
import socket
import threading

import numpy as np
import torch

from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import RunConfig, build
from test_torch_decode import NEAR_TIE

RANK_TIMEOUT_S = 240
PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8], [1, 4, 1, 4, 2, 1],
           [16, 18, 0, 3, 3, 9, 8, 8, 7], [5, 7, 7, 2, 1]]
NEW_TOKENS = 6


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def _post(port: int, prompt, n: int):
    for _ in range(1200):  # the ranks start, then rank 0 binds
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            break
        except OSError:
            await asyncio.sleep(0.1)
    body = json.dumps({"prompt": prompt, "max_new_tokens": n}).encode()
    writer.write(b"POST /v1/generate HTTP/1.1\r\nContent-Length: %d\r\n\r\n"
                 % len(body) + body)
    await writer.drain()
    data = await reader.read()
    writer.close()
    chunks = [json.loads(line) for line in data.split(b"\r\n")
              if line.startswith(b"{")]
    return [c["token"] for c in chunks if "token" in c]


def _serve_and_post(extra):
    """``serve.main`` with ``--http`` and ``extra`` in a thread, the
    clients posting from this one: (its result, the streams)."""
    port = _free_port()
    out = {}
    argv = ["--http", "--device", "cpu", "--port", str(port),
            "--serve-seconds", "2", *extra]
    thread = threading.Thread(target=lambda: out.update(result=serve.main(
        argv, rank_timeout=RANK_TIMEOUT_S)))
    thread.start()

    async def clients():
        return await asyncio.gather(*[_post(port, p, NEW_TOKENS)
                                      for p in PROMPTS])
    streams = asyncio.run(clients())
    thread.join(RANK_TIMEOUT_S)
    assert not thread.is_alive()
    return out["result"], port, streams


def _assert_parted_at_near_ties(want, got):
    """Equal, or parted where both tokens lie within ``NEAR_TIE`` of the
    best logit of the one-rank model (the command's seed-0 params)."""
    cfg = configs.smoke("qwen2-7b")
    model = build(cfg)
    params = model.init(torch.Generator(device="cpu").manual_seed(0), "cpu")
    parted = 0
    for prompt, a, b in zip(PROMPTS, want, got):
        assert len(a) == len(b) == NEW_TOKENS
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            continue
        seq = torch.tensor([prompt + a[:i]])
        with torch.no_grad():
            logits = model.forward(RunConfig(), params,
                                   {"tokens": seq})[0][0, -1].float()
        gaps = (logits.max() - logits[a[i]], logits.max() - logits[b[i]])
        assert max(gaps) <= NEAR_TIE, (i, a[i], b[i], gaps)
        parted += 1
    assert parted <= len(want) // 3, f"{parted} of {len(want)} parted"


def test_http_on_a_2x2_mesh_serves_like_one_rank():
    mesh, port, got = _serve_and_post(["--mesh", "2x2"])
    one, _, want = _serve_and_post([])
    assert mesh["port"] == port
    assert [r["port"] for r in mesh["ranks"]] == [port, None, None, None]
    for r in mesh["ranks"]:
        assert r["report"] == mesh["report"]
    report = mesh["report"]
    assert report["n_completed"] == report["n_submitted"] == len(PROMPTS)
    assert report["tokens_out"] == len(PROMPTS) * NEW_TOKENS
    assert one["report"]["n_completed"] == len(PROMPTS)
    _assert_parted_at_near_ties(want, got)
    assert np.isfinite(report["ttft_p50_s"])
