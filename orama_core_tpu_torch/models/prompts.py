"""Per-role prompt templates for the answer engine.

Mirrors the roles of the reference's prompt module
(`ai_server/src/prompts/main.py`: answer, google_query_translator/
"optimize query", party_planner — each a system+user template pair).
Templates are original text with the same functional contracts.

Port of ``orama_core_tpu/models/prompts.py``: pure Python, copied as it
is."""

from __future__ import annotations

from typing import Dict

_TEMPLATES: Dict[str, str] = {
    "answer": (
        "You are a helpful search assistant. Use ONLY the provided context "
        "to answer. If the context is insufficient, say so briefly.\n"
        "### Context\n{context}\n### Question\n{prompt}\n### Answer\n"
    ),
    # Output contract matches the reference (prompts/main.py:43-49): the
    # model must reply {"query": "<translated_query>"} so reference-tuned
    # models drop in unchanged; consumers parse via answer.parse_query_json
    "google_query_translator": (
        "Rewrite the user's question as a short refined search query. "
        'Reply ONLY with a JSON object {{"query": "<translated_query>"}} '
        "and nothing more.\n"
        "### Query\n{prompt}\n\n### Translated Query\n"
    ),
    "party_planner": (
        "Plan the steps to answer the user's request. Reply with JSON "
        '{{"actions": [{{"step": NAME, "description": TEXT}}]}} using steps '
        "from: OPTIMIZE_QUERY, GENERATE_QUERIES, PERFORM_ORAMA_SEARCH, "
        "DESCRIBE_INPUT_CODE, IMPROVE_INPUT, CREATE_CODE, ASK_FOLLOWUP, "
        "GIVE_REPLY.\nRequest: {prompt}\nJSON:"
    ),
    # -- vision roles (reference prompts/main.py:7-39: four template
    # families; "vision" is the LLMType wire name and resolves to the
    # generic analyst — the reference's chat path likewise treats vision
    # as a text chat whose prompt carries the image reference) ----------
    "vision": (
        "You describe images for a search index. Write a thorough "
        "account of everything visible in the picture and explain how "
        "the parts fit together.\n\nImage: {prompt}\n"
    ),
    "vision_generic": (
        "You describe images for a search index. Write a thorough "
        "account of everything visible in the picture and explain how "
        "the parts fit together.\n\nImage: {prompt}\n"
    ),
    "vision_ecommerce": (
        "You write storefront copy. Given a product photo, write a "
        "description a shopper would find useful: what the item is, its "
        "look and feel, and situations where someone would want it."
        "\n\nImage: {prompt}\n"
    ),
    "vision_tech_documentation": (
        "You read engineering documentation. Given a screenshot from a "
        "manual or spec, summarize what it teaches: the parts, values, "
        "and procedures it conveys.\n\nImage: {prompt}\n"
    ),
    "vision_code": (
        "You explain source code. Given a code snippet, walk through "
        "what it does, how it is built, and what problem it appears to "
        "solve.\n\nCode: {prompt}\n"
    ),
    "autoquery": (
        "Convert the natural-language request into a JSON search-params "
        'object {{"term": ..., "mode": ...}}.\nRequest: {prompt}\nJSON:'
    ),
    # -- per-action Party Planner templates ---------------------------------
    # One template per agent action, with the reference's output contracts
    # (prompts/party_planner_actions.py:34-178): JSON replies for
    # OPTIMIZE_QUERY/GENERATE_QUERIES/DESCRIBE_INPUT_CODE/CREATE_CODE,
    # plain text for IMPROVE_INPUT/ASK_FOLLOWUP/GIVE_REPLY. For most
    # actions {context} carries the step DESCRIPTION; GIVE_REPLY gets the
    # retrieved search context instead (its reference user prompt is
    # question+context).
    "pp:OPTIMIZE_QUERY": (
        "Optimize the user input into a refined search-engine query. "
        'Reply ONLY with JSON {{"query": "<optimized-query>"}}.\n'
        "### Input\n{prompt}\n\n### Description\n{context}\n"
    ),
    "pp:GENERATE_QUERIES": (
        "Create up to three distinct optimized search queries from the "
        'input. Reply ONLY with JSON {{"queries": ["<q>", "<q>"]}}.\n'
        "### Input\n{prompt}\n\n### Description\n{context}\n"
    ),
    "pp:DESCRIBE_INPUT_CODE": (
        "Describe the input code in natural language: key features, "
        "intent, and errors if any. Reply ONLY with JSON "
        '{{"description": "<code-description>"}}.\n'
        "### Input\n{prompt}\n\n### Description\n{context}\n"
    ),
    "pp:IMPROVE_INPUT": (
        "Improve the input following the instructions in the description. "
        "Reply in plain text.\n"
        "### Input\n{prompt}\n\n### Description\n{context}\n"
    ),
    "pp:CREATE_CODE": (
        "Generate code for the input, following the description. Reply "
        'ONLY with JSON {{"code": "<example-code>"}}.\n'
        "### Input\n{prompt}\n\n### Description\n{context}\n"
    ),
    "pp:ASK_FOLLOWUP": (
        "The user's question may be unclear; ask a follow-up question to "
        "clarify their inquiry, per the description.\n"
        "### Input\n{prompt}\n\n### Description\n{context}\n"
    ),
    "pp:GIVE_REPLY": (
        "You are a support agent. Answer the user's question using ONLY "
        "the provided context. Separate content into paragraphs, reply in "
        "valid markdown, name the language of any code snippet, and say "
        "you are not sure if the context is insufficient.\n"
        "### Question\n{prompt}\n\n### Context\n{context}\n"
    ),
}


def render(role: str, prompt: str, context: str = "") -> str:
    template = _TEMPLATES.get(role)
    if template is None:
        template = "{prompt}"
    return template.format(prompt=prompt, context=context)
