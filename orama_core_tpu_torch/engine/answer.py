"""Answer engine: RAG answer + multi-step "Party Planner" agent.

Counterparts:
- ``answer_events`` mirrors `answer_v0` (`web_server/api/collection/
  answer.rs:134-273`): optimize query via LLM -> hybrid search (limit 5) ->
  emit sources -> stream the answer as chunks. Event shapes match the
  reference's SseMessage enum (answer.rs:33-46): acknowledgement /
  optimizing-query / optimized-query / sources / answer_chunk / error.
- ``PartyPlanner`` mirrors the Python sidecar's agent
  (`ai_server/src/actions/party_planner.py:109-139`, prompt data
  `prompts/party_planner_actions.py:34-178`): the LLM emits a JSON action
  plan; ORAMACORE-side steps run against the read side directly
  (in-process — no HTTP back-call needed), PYTHON-side steps run through
  the LLM with per-action prompt templates (models/prompts.py "pp:*"),
  streaming actions emit one message per generated chunk
  (party_planner.py:98-133), and JSON-returning actions are decoded like
  the reference's decode_action_result (party_planner_actions.py:21-30).

Port of ``orama_core_tpu/engine/answer.py``: host code over
``read_side.search`` and ``ai.chat`` / ``ai.chat_stream``, copied line
for line (its relative imports resolve to ``orama_core_tpu_torch``).
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Dict, Iterator, List, Optional

from ..types import SearchParams
from ..utils import tracing

ANSWER_SEARCH_LIMIT = 5
GENERATED_QUERY_SEARCH_LIMIT = 3  # per-query limit under GENERATE_QUERIES


@dataclasses.dataclass(frozen=True)
class ActionSpec:
    name: str
    side: str          # "python" (LLM) | "oramacore" (engine)
    returns: str       # "text" | "json"
    streams: bool


# Registry mirroring party_planner_actions.py:34-178 (streams additionally
# covers the code/improve actions — chunking them costs nothing in-process)
ACTIONS: Dict[str, ActionSpec] = {
    a.name: a
    for a in [
        ActionSpec("OPTIMIZE_QUERY", "python", "json", False),
        ActionSpec("GENERATE_QUERIES", "python", "json", False),
        ActionSpec("PERFORM_ORAMA_SEARCH", "oramacore", "json", False),
        ActionSpec("DESCRIBE_INPUT_CODE", "python", "json", True),
        ActionSpec("IMPROVE_INPUT", "python", "text", True),
        ActionSpec("CREATE_CODE", "python", "json", True),
        ActionSpec("ASK_FOLLOWUP", "python", "text", True),
        ActionSpec("GIVE_REPLY", "python", "text", True),
    ]
}

_JSON_OBJ = re.compile(r"\{.*\}", re.DOTALL)


def _extract_json(raw: str) -> Optional[Any]:
    """Best-effort JSON object from an LLM reply (reply may wrap the JSON
    in prose/markdown fences — a light version of the reference's
    repair_json tolerance)."""
    try:
        return json.loads(raw)
    except (json.JSONDecodeError, TypeError):
        pass
    mo = _JSON_OBJ.search(raw or "")
    if mo:
        try:
            return json.loads(mo.group(0))
        except json.JSONDecodeError:
            return None
    return None


def parse_query_json(raw: str) -> str:
    """The google_query_translator reply contract is {"query": "<q>"}
    (reference prompts/main.py:43-49); fall back to the raw text when the
    model ignored the contract."""
    data = _extract_json(raw)
    if isinstance(data, dict) and isinstance(data.get("query"), str):
        return data["query"]
    return raw


def decode_action_result(action: str, raw: str) -> str:
    """Decode a JSON-returning action's reply to its payload field
    (reference decode_action_result, party_planner_actions.py:21-30);
    non-JSON replies pass through unchanged."""
    field = {
        "OPTIMIZE_QUERY": "query",
        "GENERATE_QUERIES": "queries",
        "CREATE_CODE": "code",
        "DESCRIBE_INPUT_CODE": "description",
    }.get(action)
    if field is None:
        return raw
    data = _extract_json(raw)
    if isinstance(data, dict) and field in data:
        val = data[field]
        return val if isinstance(val, str) else json.dumps(val)
    return raw


def _sse(type_: str, message: Any) -> Dict[str, Any]:
    return {"type": type_, "message": message}


def _context_from_hits(result) -> str:
    parts: List[str] = []
    for h in result.hits:
        if h.document:
            parts.append(json.dumps(h.document, ensure_ascii=False))
    return "\n".join(parts)


def answer_events(
    read_side,
    collection_id: str,
    query: str,
    conversation: Optional[List[Dict[str, str]]] = None,
    read_api_key: Optional[str] = None,
    skip_auth: bool = False,
) -> Iterator[Dict[str, Any]]:
    """The answer_v0 pipeline as a stream of SSE-message dicts."""
    ai = read_side.ai
    with tracing.span("answer", collection=collection_id):
        yield _sse("acknowledgement", "Acknowledged")
        try:
            yield _sse("optimizing-query", query)
            optimized = parse_query_json(
                ai.chat("google_query_translator", query)
            )
            yield _sse("optimized-query", optimized)

            params = SearchParams.from_json(
                {"term": optimized, "mode": "hybrid", "limit": ANSWER_SEARCH_LIMIT}
            )
            result = read_side.search(
                collection_id, params, read_api_key, skip_auth=skip_auth
            )
            yield _sse("sources", result.to_json())

            context = _context_from_hits(result)
            history = ""
            for m in conversation or []:
                history += f"{m.get('role', 'user')}: {m.get('content', '')}\n"
            prompt = (history + "user: " + query).strip()
            for chunk in ai.chat_stream("answer", prompt, context):
                yield _sse("answer_chunk", {"text": chunk, "is_final": False})
            yield _sse("answer_chunk", {"text": "", "is_final": True})
        except Exception as e:  # stream errors to the client, don't drop SSE
            yield _sse("error", f"Error during streaming: {e}")


class PartyPlanner:
    """LLM-planned multi-step agent (party_planner.py:109-139)."""

    def __init__(self, read_side) -> None:
        self.read_side = read_side
        self.ai = read_side.ai

    def plan(self, query: str) -> List[Dict[str, str]]:
        raw = self.ai.chat("party_planner", query)
        data = _extract_json(raw)
        actions = data.get("actions", []) if isinstance(data, dict) else []
        if not isinstance(actions, list):
            actions = []
        # LLM output is untrusted: tolerate bare step strings and drop
        # anything else rather than crashing the SSE stream mid-response
        valid = []
        for a in actions:
            if isinstance(a, str) and a in ACTIONS:
                valid.append({"step": a, "description": a.lower()})
            elif isinstance(a, dict) and a.get("step") in ACTIONS:
                valid.append(a)
        if not valid:
            valid = [
                {"step": "OPTIMIZE_QUERY", "description": "optimize the query"},
                {"step": "PERFORM_ORAMA_SEARCH", "description": "search"},
                {"step": "GIVE_REPLY", "description": "reply"},
            ]
        return valid

    def _search(
        self,
        collection_id: str,
        executed: Dict[str, str],
        query: str,
        read_api_key: Optional[str],
        skip_auth: bool,
    ):
        """PERFORM_ORAMA_SEARCH input selection mirrors
        _execute_orama_search (party_planner.py:59-77): the latest
        OPTIMIZE_QUERY result, else each GENERATE_QUERIES query at limit 3,
        else the raw input."""

        def run(term: str, limit: int):
            params = SearchParams.from_json(
                {"term": term, "mode": "hybrid", "limit": limit}
            )
            return self.read_side.search(
                collection_id, params, read_api_key, skip_auth=skip_auth
            )

        if "OPTIMIZE_QUERY" in executed:
            return run(executed["OPTIMIZE_QUERY"], ANSWER_SEARCH_LIMIT)
        if "GENERATE_QUERIES" in executed:
            try:
                queries = json.loads(executed["GENERATE_QUERIES"])
            except json.JSONDecodeError:
                queries = [executed["GENERATE_QUERIES"]]
            if isinstance(queries, list) and queries:
                return [
                    run(str(q), GENERATED_QUERY_SEARCH_LIMIT) for q in queries
                ]
        return run(query, ANSWER_SEARCH_LIMIT)

    def run(
        self,
        collection_id: str,
        query: str,
        conversation: Optional[List[Dict[str, str]]] = None,
        read_api_key: Optional[str] = None,
        skip_auth: bool = False,
    ) -> Iterator[Dict[str, Any]]:
        steps = self.plan(query)
        # reference labels the plan message ACTION_PLAN (party_planner.py:112)
        yield {"action": "ACTION_PLAN", "result": json.dumps({"actions": steps})}
        executed: Dict[str, str] = {}
        context = ""
        # fold chat history into the LLM steps (the route passes
        # body["messages"]; dropping it loses follow-up referents) — same
        # framing as answer_events above
        history = ""
        for m in conversation or []:
            history += f"{m.get('role', 'user')}: {m.get('content', '')}\n"
        llm_query = (history + "user: " + query).strip() if history else query
        for step in steps:
            name = step["step"]
            spec = ACTIONS[name]
            description = step.get("description", "")
            if spec.side == "oramacore":
                if name == "PERFORM_ORAMA_SEARCH":
                    result = self._search(
                        collection_id, executed, query, read_api_key, skip_auth
                    )
                    if isinstance(result, list):  # GENERATE_QUERIES fan-out
                        payload = json.dumps([r.to_json() for r in result])
                        context = "\n".join(
                            _context_from_hits(r) for r in result
                        )
                    else:
                        payload = json.dumps(result.to_json())
                        context = _context_from_hits(result)
                    executed[name] = payload
                    yield {"action": name, "result": payload}
                continue
            role = f"pp:{name}"
            # GIVE_REPLY consumes the retrieved context; other actions
            # consume the step description (prompts/party_planner_actions)
            ctx = context if name in ("GIVE_REPLY", "ASK_FOLLOWUP") else description
            if spec.streams:
                acc: List[str] = []
                for chunk in self.ai.chat_stream(role, llm_query, ctx):
                    acc.append(chunk)
                    yield {"action": name, "result": chunk}
                out = decode_action_result(name, "".join(acc))
                # terminal accumulated message (reference emits a final
                # message after the chunk stream, party_planner.py:131-139)
                yield {"action": name, "result": out, "done": True}
            else:
                out = decode_action_result(name, self.ai.chat(role, llm_query, ctx))
                yield {"action": name, "result": out}
            executed[name] = out
