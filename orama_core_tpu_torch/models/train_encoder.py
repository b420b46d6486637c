"""Contrastive training of the sentence encoder, on the card.

Port of ``scripts/train_tiny_encoder.py``: a BERT-schema encoder trained
with symmetric InfoNCE (temperature 0.05) on synthetic topic-cluster
paraphrase pairs. Two "sentences" drawn from disjoint word subsets of one
topic are positives, the batch's other rows negatives; positives usually
share no token, so the model must learn which words are topically
related, which is what the semantic tests assert of the checkpoint
(``tests/assets/tiny-semantic``).

The forward is the serving one, ``models/encoder.encode``, at f32; the
gradients come from autograd (the reference's encoder reaches no Pallas
kernel, so neither does its backward) and the optimizer is
``torch.optim.Adam`` with optax.adam's defaults (lr 2e-3, betas 0.9 and
0.999, eps 1e-8, no eps inside the root), the script's ``optax.adam(2e-3)``.
The data (``TOPICS``, ``FILLER``, ``QUERY_PREFIX``, ``OOV_JUNK``,
``gen_pairs``) is the script's, copied verbatim, so one numpy seed gives
the same pairs in both packages. ``tools/train_tiny_encoder.py`` is the
command line.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import require_device
from .encoder import EncoderConfig, encode, init_params, params_from_numpy

# ~40 everyday topic clusters. The four e2e-test domains are present with
# their passage vocabulary — general knowledge injection ("these words
# are topically related"), the same relation BGE learned at scale.
TOPICS = {
    "baking": "flour sugar butter oven tin cake bake dough pastry frosting "
    "cookie bread yeast knead whisk batter dessert sweet recipe crumb",
    "cooking": "pan stove simmer onion garlic salt pepper saute broth "
    "stew roast grill spice sauce chop boil fry kitchen chef meal",
    "astronomy": "telescope mirror light galaxies parsecs stars night "
    "observing distant nebula orbit planet comet cosmos universe "
    "astronomer constellation eclipse lunar solar faint",
    "physics": "quantum electron photon particle energy momentum wave "
    "relativity laser crystal atom nucleus field theory collider",
    "football": "striker volleyed cross corner whistle soccer goal "
    "goalkeeper midfield penalty kick pitch referee league match "
    "defender header tackle stadium fans exciting",
    "basketball": "dunk rebound dribble hoop court quarter buzzer "
    "playoff jumper layup foul coach roster arena",
    "medicine": "physician prescribed antibiotics blood infection "
    "bacterial treatment illness germs patient diagnosis symptom "
    "fever clinic nurse dose vaccine therapy hospital doctor",
    "anatomy": "heart lung kidney liver muscle bone nerve artery "
    "vein brain spine tissue organ cell",
    "weather": "rain storm cloud thunder lightning forecast humid "
    "drizzle breeze fog frost hail sunshine temperature wind",
    "ocean": "tide coral reef wave shark whale plankton current "
    "seabed shore sail harbor fishing salt marine",
    "mountains": "summit ridge glacier avalanche climb altitude trail "
    "peak slope valley alpine hike basecamp rope",
    "music": "violin melody chord rhythm orchestra concert tempo "
    "guitar drum piano singer harmony tune verse chorus",
    "painting": "canvas brush pigment portrait gallery easel sketch "
    "watercolor mural palette landscape frame artist",
    "programming": "compiler function variable loop array debug "
    "syntax runtime kernel thread memory pointer stack code",
    "databases": "query index table schema transaction commit rollback "
    "shard replica join column row cursor",
    "law": "court judge verdict statute contract plaintiff defendant "
    "appeal evidence testimony jury clause lawsuit",
    "finance": "stock dividend portfolio interest bond market equity "
    "inflation asset ledger audit loan credit invest",
    "farming": "tractor harvest wheat barn soil irrigation seed crop "
    "fertilizer plow orchard livestock pasture grain",
    "gardening": "rose tulip pruning compost bloom petal stem weed "
    "shovel greenhouse pollen lawn hedge plant",
    "aviation": "runway cockpit altitude pilot fuselage turbulence "
    "landing takeoff hangar airline wing jet radar",
    "railways": "locomotive platform track carriage timetable signal "
    "conductor freight rail station tunnel commuter",
    "automotive": "engine gearbox clutch brake tire chassis exhaust "
    "piston dashboard highway garage mechanic fuel",
    "chemistry": "molecule reaction solvent acid alkali catalyst "
    "titration beaker polymer enzyme compound reagent",
    "biology": "species evolution gene protein chromosome habitat "
    "organism bacteria virus membrane ecology mutation",
    "geology": "volcano earthquake sediment mineral fossil magma "
    "tectonic erosion quartz basalt stratum crust",
    "history": "empire dynasty revolution treaty medieval ancient "
    "archive monarch siege conquest artifact century",
    "literature": "novel poem metaphor chapter author plot narrator "
    "stanza prose manuscript editor fiction essay",
    "photography": "lens aperture shutter exposure tripod focus "
    "portrait negative zoom flash pixel frame",
    "fashion": "fabric tailor silk runway stitch garment hem couture "
    "wardrobe denim collar sleeve button",
    "carpentry": "sawdust chisel plank lumber joinery varnish dowel "
    "workbench mallet grain sand hammer nail",
    "plumbing": "pipe valve faucet drain leak gasket sewer fitting "
    "wrench pressure fixture clog",
    "electricity": "circuit voltage ampere resistor fuse wiring "
    "breaker socket conductor insulator watt grid",
    "astronomy2": "rocket satellite launch astronaut module booster "
    "capsule spacecraft mission orbit gravity payload",
    "wine": "vineyard grape vintage cork cellar tannin barrel "
    "sommelier blend aroma bottle pour",
    "coffee": "espresso roast brew grinder barista latte bean "
    "caffeine filter mug aroma crema",
    "chess": "checkmate pawn bishop gambit endgame knight rook "
    "castle opening tournament grandmaster board",
    "camping": "tent campfire sleeping lantern trailhead backpack "
    "marshmallow stove wilderness stake ranger",
    "photography2": "documentary footage camera director scene studio "
    "script editing premiere screen actor film",
    "banking": "deposit withdrawal branch teller mortgage savings "
    "account balance statement cheque vault fee",
    "meteorology": "cyclone barometer isobar pressure jetstream "
    "monsoon drought precipitation radar satellite front",
}

# function/filler words appear uniformly across every topic, so they
# carry (almost) no signal — the e2e queries are built mostly from them
FILLER = (
    "the a an of in on at to for with and or but how do i you we they it "
    "this that these those is are was were be been being have has had "
    "make made making get got take took give gave go went come came see "
    "saw look looked find found want wanted need needed just before after "
    "very really then than now here there when where what which who whom "
    "why because about around between under over against during through "
    "my your our their his her its some any many much more most other "
    "good new first last long great little own old right big high small "
    "large next early young important few public same able forty billions "
    "minutes final top exciting distant caused by an observing at night "
    # the serving query-intent prefix (registry._BGE_Q), uniform on every
    # query -> carries no signal, but must be in-vocab
    "represent sentence searching relevant passages"
).split()


# Serving embeds queries with the model's intent prefix
# (registry._BGE_Q via AIService.embed_query) and passages bare; the
# trained encoder must see the same convention or the prefix tokens
# drown the query signal. The prefix words live in the vocab and appear
# on EVERY query side, so they carry zero topical information — the
# same reason BGE's own prefix is harmless.
QUERY_PREFIX = "Represent this sentence for searching relevant passages: "

# words deliberately NOT in the vocab: real serving text contains OOV
# words that map to [UNK]; training must teach [UNK] to be
# uninformative (it is random-init otherwise and adds noise to every
# real passage)
OOV_JUNK = "zzxq qwvlk brrtz glomph snarv plixt vunde kralo".split()


def gen_pairs(rng, topics_words, n_pairs):
    names = list(topics_words)
    a_rows, b_rows, topic_ids = [], [], []
    for _ in range(n_pairs):
        ti = int(rng.integers(len(names)))
        t = names[ti]
        words = topics_words[t]
        perm = rng.permutation(len(words))
        half = len(words) // 2
        pool_a = [words[i] for i in perm[:half]]
        pool_b = [words[i] for i in perm[half:]]

        def sent(pool):
            k = int(rng.integers(3, min(8, len(pool)) + 1))
            w = list(rng.choice(pool, size=k, replace=False))
            w += list(rng.choice(FILLER, size=int(rng.integers(1, 5))))
            if rng.random() < 0.5:  # serve-time OOV -> [UNK] robustness
                w += list(rng.choice(OOV_JUNK, size=int(rng.integers(1, 4))))
            rng.shuffle(w)
            return " ".join(w)

        # side A is the QUERY side (serving prefix), side B the passage
        a_rows.append(QUERY_PREFIX + sent(pool_a))
        b_rows.append(sent(pool_b))
        topic_ids.append(ti)
    return a_rows, b_rows, np.asarray(topic_ids)



TOPIC_WORDS = {t: s.split() for t, s in TOPICS.items()}
SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
MAX_TOKENS = 32  # CLS + 8-token query prefix + sentence + SEP
TEMPERATURE = 0.05
LR, BETAS, EPS = 2e-3, (0.9, 0.999), 1e-8  # optax.adam(2e-3)'s defaults
PROBE_SEED, PROBE_PAIRS, PROBE_GATE = 12345, 256, 0.85


def build_vocab() -> List[str]:
    """The script's whole-word vocabulary: the five specials, then every
    topic and filler word, sorted (674 entries)."""
    words = {w for ws in TOPIC_WORDS.values() for w in ws} | set(FILLER)
    return SPECIALS + sorted(words)


class TrainTokenizer:
    """The script's train-time tokenizer: lowercase, ``\\w+|[^\\w\\s]``
    (punctuation a token of its own), ``[CLS] ... [SEP]``, ``[UNK]`` for
    an out-of-vocabulary word, rows cut and padded to ``max_len``. On this
    whole-word vocabulary it gives BERT WordPiece's ids
    (``hf_loader.WordPieceTokenizer``) up to their common length."""

    def __init__(self, vocab: Sequence[str], max_len: int = MAX_TOKENS) -> None:
        self.word_id = {w: i for i, w in enumerate(vocab)}
        self.max_len = max_len
        self.cls, self.sep, self.unk = (
            self.word_id[t] for t in ("[CLS]", "[SEP]", "[UNK]"))

    def __call__(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.zeros((len(texts), self.max_len), np.int32)
        mask = np.zeros((len(texts), self.max_len), np.float32)
        for i, t in enumerate(texts):
            row = [self.cls] + [
                self.word_id.get(w, self.unk)
                for w in re.findall(r"\w+|[^\w\s]", t.lower())
            ][: self.max_len - 2] + [self.sep]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1.0
        return ids, mask


def train_config(vocab_size: int, hidden: int = 96, layers: int = 2,
                 heads: int = 4) -> EncoderConfig:
    """The script's model: MLP 4 x hidden, 64 positions, f32."""
    return EncoderConfig(
        vocab_size=vocab_size, hidden=hidden, layers=layers, heads=heads,
        mlp=4 * hidden, max_len=64, out_dim=hidden, dtype=torch.float32,
    )


def named_leaves(params: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) of a nested dict / list, in a fixed order (dict keys
    sorted), e.g. ``.layers[0].q.w``; the leaves may be tensors or numpy
    arrays (the reference's pytree)."""
    if isinstance(params, dict):
        return [x for k in sorted(params)
                for x in named_leaves(params[k], f"{prefix}.{k}")]
    if isinstance(params, (list, tuple)):
        return [x for i, p in enumerate(params)
                for x in named_leaves(p, f"{prefix}[{i}]")]
    return [(prefix, params)]


def leaves(params: Any) -> List[Any]:
    """The leaves of ``named_leaves``, in its order."""
    return [t for _, t in named_leaves(params)]


def trainable(params: Any, cfg: EncoderConfig, device) -> Dict[str, Any]:
    """The port's parameters (or the reference's numpy pytree) as fresh
    f32 leaf tensors on ``device`` that require gradients; none is a view
    of another or of the input."""
    if cfg.dtype != torch.float32:
        raise ValueError(f"training runs in float32, not {cfg.dtype}")

    def fresh(p):
        if isinstance(p, dict):
            return {k: fresh(v) for k, v in p.items()}
        if isinstance(p, list):
            return [fresh(v) for v in p]
        return p.detach().clone().requires_grad_(True)

    return fresh(params_from_numpy(params, cfg, device))


def make_optimizer(params: Any) -> torch.optim.Adam:
    return torch.optim.Adam(leaves(params), lr=LR, betas=BETAS, eps=EPS)


def info_nce_loss(params, cfg: EncoderConfig, ids_a, mask_a, ids_b,
                  mask_b) -> torch.Tensor:
    """The script's ``loss_fn``: symmetric InfoNCE over the batch (row i
    of A against row i of B), logits = cosine / 0.05, through ``encode``."""
    za = encode(params, cfg, ids_a, mask_a)  # [B, d] L2-normalized
    zb = encode(params, cfg, ids_b, mask_b)
    logits = za @ zb.T / TEMPERATURE
    labels = torch.arange(za.shape[0], device=za.device)
    return 0.5 * (F.cross_entropy(logits, labels)
                  + F.cross_entropy(logits.T, labels))


def loss_and_grads(params, cfg: EncoderConfig, batch: Sequence[np.ndarray],
                   device) -> Tuple[float, List[Tuple[str, np.ndarray]]]:
    """The loss of one batch (ids_a, mask_a, ids_b, mask_b as numpy) from
    ``params`` on ``device``, and its gradient leaves as (path, host f32
    array) in ``named_leaves`` order."""
    dev = require_device(device)
    p = trainable(params, cfg, dev)
    loss = info_nce_loss(p, cfg, *(torch.from_numpy(np.asarray(x)).to(dev)
                                   for x in batch))
    loss.backward()
    return loss.item(), [(name, t.grad.detach().cpu().numpy())
                         for name, t in named_leaves(p)]


def gradient_error(got: Sequence[Tuple[str, np.ndarray]],
                   want: Sequence[Tuple[str, np.ndarray]]) -> Dict[str, float]:
    """How far two sets of gradient leaves (``loss_and_grads`` order)
    differ. ``leaf``: the largest ``max|got - want| / max|want|`` of any
    leaf but the key biases; ``key_bias``: the largest key-bias gradient
    of either over the largest ``|want|`` anywhere. A key bias adds one
    value to a whole row of attention logits, which softmax ignores, so
    its gradient is zero in exact arithmetic and both sides hold only
    rounding noise there."""
    if [n for n, _ in got] != [n for n, _ in want]:
        raise ValueError("the gradient leaves differ in their paths")
    largest = max(float(np.abs(w).max()) for _, w in want)
    leaf = key_bias = 0.0
    for (name, g), (_, w) in zip(got, want):
        if name.endswith(".k.b"):
            key_bias = max(key_bias, float(np.abs(g).max()) / largest,
                           float(np.abs(w).max()) / largest)
        else:
            leaf = max(leaf, float(np.abs(g - w).max())
                       / max(float(np.abs(w).max()), 1e-30))
    return {"leaf": leaf, "key_bias": key_bias}


def sample_batch(rng: np.random.Generator, tokenizer: TrainTokenizer,
                 batch: int, device) -> Tuple[torch.Tensor, ...]:
    """``batch`` fresh pairs from ``gen_pairs``, tokenized: (ids_a,
    mask_a, ids_b, mask_b) on ``device``."""
    a_rows, b_rows, _ = gen_pairs(rng, TOPIC_WORDS, batch)
    ids_a, mask_a = tokenizer(a_rows)
    ids_b, mask_b = tokenizer(b_rows)
    return tuple(torch.from_numpy(x).to(device)
                 for x in (ids_a, mask_a, ids_b, mask_b))


def train_step(params, cfg: EncoderConfig, opt: torch.optim.Optimizer,
               batch: Sequence[torch.Tensor]) -> torch.Tensor:
    """One step: the loss, its gradients by autograd, one Adam update.
    Returns the loss (detached; reading it waits for the device)."""
    loss = info_nce_loss(params, cfg, *batch)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def train(cfg: EncoderConfig, steps: int, batch: int, seed: int = 0,
          device="cuda", params: Any = None,
          log: Optional[Callable[[str], None]] = None):
    """The script's training loop on ``device``: ``steps`` Adam steps over
    fresh batches of ``batch`` pairs drawn from ``np.random.default_rng(
    seed)``. The initial parameters are ``params`` (the port's, or the
    reference's numpy pytree) or ``init_params`` drawn from a CPU
    generator seeded ``seed``, so the card and the CPU start alike.
    Returns (parameters, loss of every step)."""
    dev = require_device(device)
    if params is None:
        params = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    params = trainable(params, cfg, dev)
    opt = make_optimizer(params)
    rng = np.random.default_rng(seed)
    tok = TrainTokenizer(build_vocab())
    losses = []
    for it in range(steps):
        losses.append(train_step(params, cfg, opt,
                                 sample_batch(rng, tok, batch, dev)))
        if log is not None and (it % 100 == 0 or it == steps - 1):
            log(f"step {it}: loss {float(losses[-1]):.4f}")
    return params, torch.stack(losses).tolist() if losses else []


@torch.no_grad()
def topic_probe(params, cfg: EncoderConfig, device=None) -> Dict[str, float]:
    """The script's held-out probe: 256 fresh pairs (seed 12345), each A
    side against every B side. ``topic``: the best B is of the A side's
    topic (the property the semantic tests need; the gate is > 0.85);
    ``pair``: it is the A side's own pair (capped near 1/6 by design, as
    same-topic candidates are indistinguishable to a topical encoder)."""
    dev = torch.device(device) if device is not None else leaves(params)[0].device
    pa, pb, ptopic = gen_pairs(np.random.default_rng(PROBE_SEED), TOPIC_WORDS,
                               PROBE_PAIRS)
    tok = TrainTokenizer(build_vocab())
    z = [encode(params, cfg, *(torch.from_numpy(x).to(dev) for x in tok(rows)))
         for rows in (pa, pb)]
    best = (z[0] @ z[1].T).argmax(1).cpu().numpy()
    return {"topic": float(np.mean(ptopic[best] == ptopic)),
            "pair": float(np.mean(best == np.arange(len(pa)))),
            "chance": 1.0 / len(TOPICS)}


@torch.no_grad()
def roundtrip_cosine(params, cfg: EncoderConfig, path: str, device) -> float:
    """The script's round trip: two probe texts through the trained
    parameters (train tokenizer) and through the checkpoint at ``path`` as
    serving loads it (``hf_loader``'s reader and WordPiece tokenizer, the
    default bf16); the least cosine of the two rows, compared on the
    common length (the loader pads to power-of-two buckets)."""
    from .hf_loader import load_encoder_checkpoint, load_encoder_tokenizer

    loaded = load_encoder_checkpoint(path)
    if loaded is None:
        raise ValueError(f"{path} does not load as an encoder checkpoint")
    cfg2, tree = loaded
    tok2 = load_encoder_tokenizer(path, cfg2.max_len)
    if tok2 is None:
        raise ValueError(f"{path} has no tokenizer the loader reads")
    dev = require_device(device)
    probe = ["flour sugar oven", "telescope stars night"]
    ids2, mask2 = tok2(probe)
    z2 = encode(params_from_numpy(tree, cfg2, dev), cfg2,
                torch.from_numpy(ids2).to(dev), torch.from_numpy(mask2).to(dev))
    ids1, mask1 = TrainTokenizer(build_vocab())(probe)
    n = ids2.shape[1]
    z1 = encode(params, cfg, torch.from_numpy(ids1[:, :n]).to(dev),
                torch.from_numpy(mask1[:, :n]).to(dev))
    return float((z1 * z2).sum(-1).min())
