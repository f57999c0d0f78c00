"""Local training data for the sentence encoder.

The port's own copy of ``hyperdb_tpu/models/localdata.py``, which imports
nothing but ``ast``, ``os``, ``re`` and NumPy: the port may not import the
JAX package, so it keeps this module beside its trainer. Every function
draws from the same seeds with the same NumPy generator calls and walks the
same files in the same order, so on one machine it returns the JAX module's
output list for list. Nothing here touches a device.

1. :func:`concept_corpus` — a templated entity-profile corpus with a
   controlled paraphrase structure: each latent concept has several
   disjoint surface phrasings; documents render a concept with one phrasing
   and queries mention it with another, so a query shares few words with
   its target. :func:`training_pairs` and :func:`retrieval_eval_set` draw
   disjoint entities and concept combinations from it.
2. natural prose from local files: docstrings of the standard library
   (:func:`stdlib_texts`, and the held-out subpackages of
   :func:`stdlib_heldout_texts`), of installed packages
   (:func:`package_texts`) and documentation files (:func:`image_texts`),
   cropped into span pairs (:func:`stdlib_span_pairs`, :func:`span_pairs`).

:func:`evaluate_retrieval` scores any ``encode`` (texts -> (n, d) float32)
by recall@k and MRR with NumPy on the host.
"""

from __future__ import annotations

import ast
import os
import re

import numpy as np

# ---------------------------------------------------------------------------
# Concept bank: each concept has >= 4 surface phrasings with deliberately low
# mutual word overlap. Queries and documents always draw DIFFERENT surfaces.
# ---------------------------------------------------------------------------

CONCEPTS: dict[str, list[str]] = {
    "sleep": [
        "sleeps through most of the day",
        "naps constantly in warm corners",
        "dozes for hours beneath the rocks",
        "spends the afternoon slumbering",
        "is rarely awake before dusk",
    ],
    "water": [
        "lives near rivers and shallow streams",
        "makes its home by the waterside",
        "is found along lakes and wet marshes",
        "never strays far from the shore",
        "favors damp pools and flooded caves",
    ],
    "fly": [
        "soars high above the cliffs",
        "rides the wind for days without rest",
        "glides silently over open fields",
        "circles the peaks on broad wings",
        "drifts with the storm currents",
    ],
    "dig": [
        "burrows long tunnels underground",
        "digs deep chambers below the surface",
        "excavates winding dens in the soil",
        "carves hollows beneath tree roots",
        "tunnels through packed earth with ease",
    ],
    "sing": [
        "sings at dusk to mark its territory",
        "calls out with a melodic evening cry",
        "whistles long tunes from the treetops",
        "hums a low song when content",
        "fills the valley with its voice",
    ],
    "hoard": [
        "hoards shiny pebbles and lost trinkets",
        "collects glittering stones in its den",
        "gathers bright objects obsessively",
        "stockpiles polished shells and beads",
        "keeps a stash of gleaming treasures",
    ],
    "hunt": [
        "hunts small prey at first light",
        "stalks its quarry through tall grass",
        "ambushes anything that wanders close",
        "chases down insects with darting strikes",
        "preys on whatever crosses its path",
    ],
    "cold": [
        "thrives in snowfields and bitter frost",
        "prefers the coldest mountain slopes",
        "is at home in ice caves and glaciers",
        "endures freezing winds without shelter",
        "waits out blizzards buried in snow",
    ],
    "heat": [
        "basks on sun-scorched desert stones",
        "tolerates searing midday temperatures",
        "lingers near lava vents and hot springs",
        "flourishes in dry burning badlands",
        "absorbs warmth from heated sand",
    ],
    "night": [
        "is active only after dark",
        "emerges when the moon rises",
        "prowls during the midnight hours",
        "avoids daylight entirely",
        "wakes as the stars come out",
    ],
    "social": [
        "travels in large noisy packs",
        "is never seen without its herd",
        "forms tight-knit family groups",
        "migrates in sweeping flocks",
        "shares its den with many companions",
    ],
    "solitary": [
        "lives entirely alone",
        "defends a territory of its own",
        "avoids others of its kind",
        "wanders the wilds as a loner",
        "meets its kin only to quarrel",
    ],
    "fast": [
        "outruns everything on the plains",
        "moves in sudden lightning bursts",
        "races storms across open ground",
        "is too quick for the eye to follow",
        "dashes between shadows in a blink",
    ],
    "strong": [
        "topples trees with a single blow",
        "carries boulders twice its size",
        "crushes stone between its jaws",
        "is famed for its immense power",
        "drags whole logs back to its nest",
    ],
    "shy": [
        "hides at the faintest sound",
        "flees from anything unfamiliar",
        "is almost impossible to approach",
        "melts into the undergrowth when seen",
        "trembles and retreats from strangers",
    ],
    "curious": [
        "investigates every new scent",
        "pokes its nose into travelers' packs",
        "follows wanderers out of curiosity",
        "studies unfamiliar objects for hours",
        "cannot resist exploring strange places",
    ],
    "glow": [
        "glows with a soft inner light",
        "shimmers faintly in the dark",
        "gives off a pale luminous haze",
        "lights caverns with its radiance",
        "flickers like a lantern at night",
    ],
    "armor": [
        "is covered in thick bony plates",
        "wears a shell harder than iron",
        "carries natural armor on its back",
        "deflects blows with its rigid hide",
        "is protected by overlapping scales",
    ],
    "venom": [
        "delivers a paralyzing sting",
        "carries potent toxins in its fangs",
        "secretes a numbing poison",
        "tips its spines with venom",
        "leaves a toxic trace on whatever it touches",
    ],
    "heal": [
        "mends the wounds of other creatures",
        "tends to injured companions",
        "soothes pain with its warm aura",
        "is sought out for its restorative touch",
        "nurses the sick back to strength",
    ],
    "fruit": [
        "feeds on fallen orchard fruit",
        "forages for ripe berries",
        "raids melon patches at harvest time",
        "lives on sweet windfall apples",
        "picks soft figs from low branches",
    ],
    "fish": [
        "catches fish with practiced ease",
        "snaps minnows from the current",
        "dives for trout in clear pools",
        "waits motionless to spear passing fish",
        "scoops fry from the riverbed",
    ],
    "storm": [
        "appears just before thunderstorms",
        "dances in the lightning's glare",
        "follows the path of rolling thunder",
        "is drawn to charged stormy skies",
        "rides ahead of the breaking gale",
    ],
    "mimic": [
        "imitates the calls of other animals",
        "copies any sound it hears",
        "echoes voices back at travelers",
        "disguises itself as common wildlife",
        "repeats whole songs note for note",
    ],
}

# Extension pool for the HARD benchmark (localdata v2): with only 24
# concepts, 1000 3-concept docs share each concept PAIR ~11 ways, capping a
# perfect retriever's expected recall@10 at ~0.86 (retrieval_eval_ceiling).
# 56 concepts push pair collisions to ~2, raising the ceiling toward 1.0 so
# encoder progress stays measurable after the base benchmark saturates.
CONCEPTS_EXTRA: dict[str, list[str]] = {
    "burrow": [
        "digs winding tunnels under the meadow",
        "excavates deep warrens in soft soil",
        "vanishes into holes of its own making",
        "hollows out dens beneath tree roots",
        "carves burrows into the hillside",
    ],
    "dawn_chorus": [
        "sings long melodies at first light",
        "fills the valley with warbling song",
        "performs trilling choruses at dawn",
        "hums layered tunes to its kin",
        "whistles intricate refrains all morning",
    ],
    "trinket_hoard": [
        "hoards shiny pebbles in its nest",
        "collects trinkets and hides them away",
        "stockpiles seeds for the lean season",
        "gathers glittering objects obsessively",
        "squirrels away anything it can carry",
    ],
    "freeze": [
        "withstands bitter cold without shelter",
        "thrives in frost and deep snow",
        "sleeps comfortably on bare ice",
        "endures blizzards that fell larger beasts",
        "is unbothered by the harshest winters",
    ],
    "field_medic": [
        "mends the wounds of injured companions",
        "tends to the hurt of its herd",
        "nurses sick creatures back to health",
        "soothes injuries with practiced care",
        "is sought out by the wounded",
    ],
    "venom_fang": [
        "carries a paralyzing venom in its fangs",
        "delivers a toxin that numbs its prey",
        "secretes poison along its spines",
        "strikes with venom-laced barbs",
        "defends itself with a potent sting",
    ],
    "night_glow": [
        "glows faintly in the dark",
        "emits a soft light from its markings",
        "shines with an inner luminescence",
        "lights caverns with its pale radiance",
        "flickers like a lantern at night",
    ],
    "swim_deep": [
        "dives to the lightless ocean floor",
        "hunts in the crushing deep",
        "descends far below the waves",
        "prowls abyssal trenches",
        "surfaces only rarely from the depths",
    ],
    "climb": [
        "scales sheer cliffs without effort",
        "clambers up vertical rock faces",
        "ascends the tallest trees in moments",
        "grips stone walls like a spider",
        "is happiest high on a crag",
    ],
    "trick": [
        "misleads travelers with false trails",
        "plays elaborate pranks on intruders",
        "lures the curious into harmless traps",
        "deceives predators with cunning ruses",
        "outwits anything that hunts it",
    ],
    "guard": [
        "stands watch over its territory all night",
        "patrols the borders of its home",
        "defends its grove against all comers",
        "keeps vigilant sentry on the ridge",
        "protects its clutch with fierce devotion",
    ],
    "storm_call": [
        "summons sudden squalls when threatened",
        "stirs the clouds into thunder",
        "brings rain wherever it lingers",
        "is followed by rolling storms",
        "crackles with gathering lightning",
    ],
    "mirror": [
        "reflects its surroundings like polished glass",
        "blends in by mirroring nearby colors",
        "shimmers with a mirrored hide",
        "is nearly invisible against any backdrop",
        "camouflages perfectly in plain sight",
    ],
    "feast": [
        "devours twice its weight daily",
        "eats without pause from dawn to dusk",
        "strips whole orchards bare",
        "has an appetite that alarms farmers",
        "forages relentlessly for anything edible",
    ],
    "dream": [
        "walks in circles while fast asleep",
        "acts out its dreams with twitching paws",
        "murmurs strange sounds while dreaming",
        "wanders at night without waking",
        "is famous for its restless sleepwalking",
    ],
    "stone_skin": [
        "has hide as hard as granite",
        "shrugs off blows with its rocky shell",
        "is armored in mineral plates",
        "turns aside claws with stone-like scales",
        "wears a carapace of living rock",
    ],
    "swift": [
        "outruns every creature on the plain",
        "sprints faster than the eye can follow",
        "covers miles in a few heartbeats",
        "is a blur when it chooses to run",
        "leaves pursuers far behind",
    ],
    "scent": [
        "tracks prey by scent across whole valleys",
        "smells water from miles away",
        "follows week-old trails by nose alone",
        "detects intruders by their faintest odor",
        "navigates entirely by smell",
    ],
    "night_eyes": [
        "sees clearly in total darkness",
        "hunts by starlight alone",
        "has eyes that gather the faintest glow",
        "watches the night as if it were day",
        "is blind at noon but sharp-eyed at midnight",
    ],
    "root": [
        "draws nourishment from buried roots",
        "feeds on sap and deep taproots",
        "unearths tubers with practiced ease",
        "lives on what it digs from the ground",
        "grubs for roots beneath old stumps",
    ],
    "echo": [
        "navigates by bouncing sharp clicks",
        "maps caves with reflected sound",
        "finds its way by echoes alone",
        "chirps to sound out hidden passages",
        "hears the shape of the world around it",
    ],
    "molt": [
        "sheds its skin with every season",
        "leaves papery husks where it rested",
        "outgrows and discards its shell yearly",
        "renews its plumage in a single night",
        "emerges brighter after each molt",
    ],
    "magnet": [
        "always faces magnetic north at rest",
        "senses the pull of distant lodestone",
        "orients itself by the planet's field",
        "is drawn toward buried iron",
        "navigates by an inner compass",
    ],
    "song_mimic": [
        "borrows the melodies of other songbirds",
        "weaves stolen tunes into its own calls",
        "answers every song with a copy",
        "learns new melodies after one hearing",
        "trades songs with passing flocks",
    ],
    "tide_pull": [
        "appears only at the lowest tide",
        "follows the ebb and flow of the sea",
        "times its hunts to the tide tables",
        "beaches itself at every neap tide",
        "rides the tidal bore upriver",
    ],
    "ember_breath": [
        "exhales thin wisps of smoke",
        "breathes sparks when startled",
        "warms its den with heated breath",
        "singes the grass where it sighs",
        "puffs cinders while it sleeps",
    ],
    "puzzle": [
        "opens latches and knotted cords with ease",
        "solves mazes on the first attempt",
        "dismantles traps set for it",
        "figures out locks that stump its keepers",
        "studies mechanisms until they yield",
    ],
    "herd_mind": [
        "moves in flocks that turn as one",
        "thinks with the whole of its swarm",
        "coordinates wordlessly with its kin",
        "acts in perfect unison with its group",
        "shares alarm across the herd instantly",
    ],
    "still": [
        "stands motionless for hours on end",
        "freezes so completely it seems carved",
        "waits unmoving until prey forgets it",
        "can hold one pose from dawn to dusk",
        "is often mistaken for a statue",
    ],
    "rain_dance": [
        "celebrates every downpour with leaping",
        "dances in circles when rain begins",
        "drums puddles with delighted stomps",
        "greets wet weather with wild capering",
        "only plays during a storm's first drops",
    ],
    "salt": [
        "licks mineral deposits from canyon walls",
        "travels far to reach salt flats",
        "craves brine and salted pools",
        "gnaws salty crusts off sea rocks",
        "gathers where the earth tastes of salt",
    ],
    "twin": [
        "is never seen without its twin",
        "hunts in mirrored pairs",
        "shares every meal with its double",
        "moves in tandem with a lifelong partner",
        "is one half of an inseparable pair",
    ],
}

# The hard pool: 56 concepts -> C(56,2)=1540 pairs, ~2 docs per pair at
# 1000 3-concept docs — near-unique targets, ceiling ~1.0. The extra keys
# are DISJOINT from the base pool (asserted) so base surfaces are never
# overridden and the two benchmarks stay independent.
assert not set(CONCEPTS) & set(CONCEPTS_EXTRA), sorted(
    set(CONCEPTS) & set(CONCEPTS_EXTRA)
)
CONCEPTS_HARD: dict[str, list[str]] = {**CONCEPTS, **CONCEPTS_EXTRA}

TYPES = ["ember", "tide", "vine", "storm", "stone", "gale", "frost",
         "shadow", "light", "iron"]

_SYLLA = ["ka", "ru", "mo", "ti", "ve", "sha", "lo", "zi", "pon", "dra",
          "ne", "qua", "fel", "gor", "mi", "tu", "bel", "os", "ya", "ki"]

_QUERY_TEMPLATES = [
    "a creature that {c}",
    "which one {c}?",
    "find the {t} creature that {c}",
    "looking for something that {c}",
    "it {c}",
]

# Two-concept queries: mentioning two of a document's three concepts makes
# the target (nearly) unique among 1000 docs, where a single concept is
# shared by ~12% of the corpus — raising the achievable recall ceiling.
_QUERY2_TEMPLATES = [
    "a creature that {c0} and {c1}",
    "which {t} creature {c0} and also {c1}?",
    "looking for one that {c0}; it also {c1}",
    "find something that {c0} and {c1}",
    "it {c0} and it {c1}",
]

_DOC_TEMPLATES = [
    "{name} is a {t}-aligned creature. It {c0}. It also {c1}. Keepers note that it {c2}.",
    "The {t} creature {name} {c0} and {c1}. Old field guides say it {c2}.",
    "{name}, of the {t} kind, {c0}. Unusually, it {c1}; moreover it {c2}.",
]


def _entity_name(rng: np.random.Generator) -> str:
    parts = rng.choice(len(_SYLLA), size=3, replace=True)
    return "".join(_SYLLA[p] for p in parts).capitalize()


def concept_corpus(
    num_docs: int = 4000,
    seed: int = 0,
    concepts_per_doc: int = 3,
    pool: dict | None = None,
):
    """Entity-profile documents with latent concept assignments.

    Returns (docs, doc_concepts, doc_surface_ids, doc_types): ``docs`` are
    text documents; ``doc_concepts[i]`` the concept keys rendered into doc
    i; ``doc_surface_ids[i]`` which surface index each concept used;
    ``doc_types[i]`` the creature type word rendered into the text.
    """
    if concepts_per_doc != 3:
        raise ValueError(
            "concept_corpus renders exactly 3 concepts per document (the "
            "doc templates have 3 slots)."
        )
    pool = CONCEPTS if pool is None else pool
    rng = np.random.default_rng(seed)
    keys = sorted(pool)
    docs, doc_concepts, doc_surfaces, doc_types = [], [], [], []
    for i in range(num_docs):
        chosen = rng.choice(len(keys), size=concepts_per_doc, replace=False)
        ckeys = [keys[c] for c in chosen]
        sids = [int(rng.integers(0, len(pool[k]))) for k in ckeys]
        name = _entity_name(rng)
        typ = TYPES[int(rng.integers(0, len(TYPES)))]
        tmpl = _DOC_TEMPLATES[int(rng.integers(0, len(_DOC_TEMPLATES)))]
        text = tmpl.format(
            name=name, t=typ,
            c0=pool[ckeys[0]][sids[0]],
            c1=pool[ckeys[1]][sids[1]],
            c2=pool[ckeys[2]][sids[2]],
        )
        docs.append(text)
        doc_concepts.append(ckeys)
        doc_surfaces.append(sids)
        doc_types.append(typ)
    return docs, doc_concepts, doc_surfaces, doc_types


def paraphrase_query(
    concept_key: str,
    doc_surface_id: int,
    rng: np.random.Generator,
    doc_type: str | None = None,
    pool: dict | None = None,
) -> str:
    """A query about ``concept_key`` using a surface DIFFERENT from the one
    rendered in the document (the paraphrase gap the encoder must learn).
    When the template mentions a creature type it uses the TARGET document's
    type — a weak lexical anchor every encoder (including the hash baseline)
    can exploit, keeping the benchmark fair rather than purely adversarial
    to lexical methods."""
    surface = _other_surface(concept_key, doc_surface_id, rng, pool)
    tmpl = _QUERY_TEMPLATES[int(rng.integers(0, len(_QUERY_TEMPLATES)))]
    typ = doc_type or TYPES[int(rng.integers(0, len(TYPES)))]
    return tmpl.format(c=surface, t=typ)


def _other_surface(concept_key: str, doc_surface_id: int, rng,
                   pool: dict | None = None) -> str:
    surfaces = (CONCEPTS if pool is None else pool)[concept_key]
    choices = [j for j in range(len(surfaces)) if j != doc_surface_id]
    return surfaces[choices[int(rng.integers(0, len(choices)))]]


def paraphrase_query2(
    doc_concepts: list[str],
    doc_surfaces: list[int],
    rng: np.random.Generator,
    doc_type: str,
    pool: dict | None = None,
) -> str:
    """A query mentioning TWO of the document's concepts, each with a
    surface different from the document's rendering."""
    picks = rng.choice(len(doc_concepts), size=2, replace=False)
    c0 = _other_surface(doc_concepts[picks[0]], doc_surfaces[picks[0]], rng, pool)
    c1 = _other_surface(doc_concepts[picks[1]], doc_surfaces[picks[1]], rng, pool)
    tmpl = _QUERY2_TEMPLATES[int(rng.integers(0, len(_QUERY2_TEMPLATES)))]
    return tmpl.format(c0=c0, c1=c1, t=doc_type)


def training_pairs(num_pairs: int = 20000, seed: int = 1,
                   pool: dict | None = None):
    """(query, positive document) pairs over a fresh training corpus."""
    docs, doc_concepts, doc_surfaces, doc_types = concept_corpus(
        num_docs=max(1000, num_pairs // 4), seed=seed, pool=pool
    )
    rng = np.random.default_rng(seed + 1)
    pairs = []
    for n in range(num_pairs):
        di = int(rng.integers(0, len(docs)))
        if n % 2 == 0:  # mix single- and two-concept query styles
            ci = int(rng.integers(0, len(doc_concepts[di])))
            q = paraphrase_query(
                doc_concepts[di][ci], doc_surfaces[di][ci], rng,
                doc_types[di], pool,
            )
        else:
            q = paraphrase_query2(
                doc_concepts[di], doc_surfaces[di], rng, doc_types[di], pool
            )
        pairs.append((q, docs[di]))
    return pairs


def retrieval_eval_set(
    num_docs: int = 1000, num_queries: int = 200, seed: int = 777,
    pool: dict | None = None,
):
    """Held-out corpus + paraphrase queries with known target documents.

    The seed is disjoint from training (fresh entities, fresh concept
    combinations, and each query's surface differs from its document's), so
    a high recall requires surface->concept generalization.
    """
    docs, doc_concepts, doc_surfaces, doc_types = concept_corpus(
        num_docs=num_docs, seed=seed, pool=pool
    )
    rng = np.random.default_rng(seed + 1)
    queries, targets = [], []
    for _ in range(num_queries):
        di = int(rng.integers(0, len(docs)))
        queries.append(
            paraphrase_query2(
                doc_concepts[di], doc_surfaces[di], rng, doc_types[di], pool
            )
        )
        targets.append(di)
    return docs, queries, targets


def evaluate_retrieval(encode, ks=(1, 10), eval_set=None):
    """Recall@k / MRR of an encoder on the held-out paraphrase benchmark.

    ``encode`` maps a list of texts to (n, d) float32 embeddings. Ranking is
    plain cosine (the engine's default metric). Returns a dict of metrics.
    """
    docs, queries, targets = eval_set or retrieval_eval_set()
    d_emb = np.array(encode(docs), dtype=np.float32)
    q_emb = np.array(encode(queries), dtype=np.float32)
    d_emb /= np.maximum(np.linalg.norm(d_emb, axis=1, keepdims=True), 1e-12)
    q_emb /= np.maximum(np.linalg.norm(q_emb, axis=1, keepdims=True), 1e-12)
    sims = q_emb @ d_emb.T  # (Q, N)
    order = np.argsort(-sims, axis=1)
    ranks = np.empty(len(queries), dtype=np.int64)
    for qi, tgt in enumerate(targets):
        ranks[qi] = int(np.where(order[qi] == tgt)[0][0])
    out = {f"recall@{k}": float(np.mean(ranks < k)) for k in ks}
    out["mrr"] = float(np.mean(1.0 / (ranks + 1)))
    return out


# ---------------------------------------------------------------------------
# Natural prose from the standard library (vocab enrichment + span pairs)
# ---------------------------------------------------------------------------

_SENTENCE_RE = re.compile(r"[A-Z][^.!?]{30,400}[.!?]")


def stdlib_texts(max_files: int = 400, min_len: int = 60) -> list[str]:
    """Docstring paragraphs mined from the Python standard library, in
    deterministic (sorted path) order. Pure local data — no network."""
    stdlib_dir = os.path.dirname(os.__file__)
    texts: list[str] = []
    names = sorted(
        f for f in os.listdir(stdlib_dir)
        if f.endswith(".py") and not f.startswith("_")
    )[:max_files]
    for name in names:
        path = os.path.join(stdlib_dir, name)
        try:
            with open(path, encoding="utf-8", errors="ignore") as f:
                tree = ast.parse(f.read())
        except (OSError, SyntaxError, ValueError):
            continue
        for node in ast.walk(tree):
            if isinstance(
                node,
                (ast.Module, ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
            ):
                doc = ast.get_docstring(node)
                if doc:
                    cleaned = " ".join(doc.split())
                    if len(cleaned) >= min_len:
                        texts.append(cleaned)
    return texts


def stdlib_heldout_texts(min_len: int = 60, max_texts: int = 4000) -> list[str]:
    """Docstrings from stdlib SUBPACKAGE modules — text the encoder has
    never seen: the out-of-distribution eval source.

    :func:`stdlib_texts` (the vocab-building + span-pretraining source)
    lists only TOP-LEVEL ``*.py`` files of the stdlib directory; package
    directories (email/, logging/, unittest/, json/, ...) were never
    walked, so their docstrings are disjoint training-wise by construction.
    Belt and braces, any paragraph that exactly matches a training
    paragraph is dropped too."""
    stdlib_dir = os.path.dirname(os.__file__)
    seen = set(stdlib_texts())
    texts: list[str] = []
    pkg_dirs = sorted(
        f for f in os.listdir(stdlib_dir)
        if os.path.isdir(os.path.join(stdlib_dir, f))
        and not f.startswith("_")
        and f not in ("site-packages", "dist-packages", "test", "lib2to3")
        and os.path.exists(os.path.join(stdlib_dir, f, "__init__.py"))
    )
    for pkg in pkg_dirs:
        pkg_path = os.path.join(stdlib_dir, pkg)
        for name in sorted(os.listdir(pkg_path)):
            if not name.endswith(".py"):
                continue
            path = os.path.join(pkg_path, name)
            try:
                with open(path, encoding="utf-8", errors="ignore") as f:
                    tree = ast.parse(f.read())
            except (OSError, SyntaxError, ValueError):
                continue
            for node in ast.walk(tree):
                if isinstance(
                    node,
                    (ast.Module, ast.FunctionDef, ast.AsyncFunctionDef,
                     ast.ClassDef),
                ):
                    doc = ast.get_docstring(node)
                    if doc:
                        cleaned = " ".join(doc.split())
                        if len(cleaned) >= min_len and cleaned not in seen:
                            texts.append(cleaned)
            if len(texts) >= max_texts:
                return texts
    return texts


def heldout_span_eval_set(
    num_docs: int = 800, min_half_len: int = 40, skip_docs: int = 0
) -> tuple[list[str], list[str], list[int]]:
    """(corpus, queries, targets) for the OOD docstring-retrieval eval.

    Each held-out docstring with >= 2 sentences splits into two disjoint
    sentence halves: the first half is the QUERY, the second half the
    corpus DOCUMENT; recall@k asks whether an encoder ranks a docstring's
    other half above ``num_docs - 1`` distractor halves. Topic match
    without guaranteed word overlap — the same objective shape the encoder
    pretrained on, but on text it never saw.

    ``skip_docs`` skips the first N eligible docstrings — the reported OOD
    eval uses the FIRST 800 (benchmarks/eval_ood.py), so a training run
    that wants an OOD *validation* signal for checkpoint selection must
    draw from a later, disjoint slice (``skip_docs=800``) to keep the
    reported eval untouched by model selection."""
    docs: list[str] = []
    queries: list[str] = []
    targets: list[int] = []
    skipped = 0
    for text in stdlib_heldout_texts():
        sentences = _SENTENCE_RE.findall(text)
        if len(sentences) < 2:
            continue
        half = len(sentences) // 2
        a = " ".join(sentences[:half])
        b = " ".join(sentences[half:])
        if len(a) < min_half_len or len(b) < min_half_len:
            continue
        if skipped < skip_docs:
            skipped += 1
            continue
        targets.append(len(docs))
        docs.append(b)
        queries.append(a)
        if len(docs) >= num_docs:
            break
    return docs, queries, targets


def stdlib_span_pairs(max_pairs: int = 8000) -> list[tuple[str, str]]:
    """Contrastive (span, other-span-of-same-docstring) pairs: two disjoint
    sentence runs of one docstring are positives (they share a topic, not
    necessarily words) — the classic unsupervised cropping objective."""
    pairs = []
    for text in stdlib_texts():
        sentences = _SENTENCE_RE.findall(text)
        if len(sentences) >= 2:
            half = len(sentences) // 2
            a = " ".join(sentences[:half])
            b = " ".join(sentences[half:])
            if len(a) > 40 and len(b) > 40:
                pairs.append((a, b))
        if len(pairs) >= max_pairs:
            break
    return pairs


# Installed third-party packages with substantial natural-English docstring
# prose (far more than the stdlib's top-level modules). Disjoint BY PATH from the
# OOD eval source (stdlib subpackage modules), so training on them cannot
# leak eval text; vendored-copy hygiene below drops exact matches anyway.
PACKAGE_PROSE_ROOTS = (
    "numpy", "jax", "scipy", "torch", "transformers", "flax", "optax",
    "pandas", "sklearn", "chex", "orbax", "haiku", "matplotlib", "sympy",
)


def all_package_roots() -> tuple:
    """EVERY top-level site-packages package directory (sorted): the
    widest docstring corpus, beyond the hand-picked
    ``PACKAGE_PROSE_ROOTS``."""
    import sysconfig

    site = sysconfig.get_paths()["purelib"]
    return tuple(sorted(
        d for d in os.listdir(site)
        if os.path.isdir(os.path.join(site, d))
        and not d.endswith(".dist-info")
        and not d.startswith("_")
    ))


_DOC_FILE_ROOTS = ("/usr/share/doc",)


def _prose_paragraphs(raw: str, min_len: int) -> list[str]:
    """Blank-line paragraphs of ``raw`` that read as natural English prose:
    markdown/rst furniture (headers, rules, tables, code fences) stripped,
    whitespace normalized, and each paragraph must contain at least one
    sentence-shaped span with a mostly-alphabetic character mix (drops
    code blocks, option tables, and changelog stanzas)."""
    out: list[str] = []
    for para in re.split(r"\n\s*\n", raw):
        lines = []
        fenced = False
        for line in para.splitlines():
            s = line.strip()
            if s.startswith("```"):
                fenced = not fenced
                continue
            if fenced or not s:
                continue
            if s.startswith(("#", "=", "-", "*", "|", ">", "+", ".. ")):
                # header/rule/table/bullet furniture; bullets often hold
                # prose but their fragments skew the span statistics
                continue
            lines.append(s)
        cleaned = " ".join(" ".join(lines).split())
        if len(cleaned) < min_len:
            continue
        alpha = sum(c.isalpha() or c == " " for c in cleaned)
        if alpha / len(cleaned) < 0.8:
            continue
        if not _SENTENCE_RE.search(cleaned):
            continue
        out.append(cleaned)
    return out


def image_texts(max_texts: int = 40000, min_len: int = 80) -> list[str]:
    """Natural-prose paragraphs from documentation FILES installed on
    the machine: ``*.md`` / ``*.rst`` / ``*.txt`` under site-packages
    (READMEs, guides, changelogs) plus ``/usr/share/doc`` (gzip-aware).
    This register — project prose, feature notes,
    installation guides — is different from docstrings, which is exactly
    the axis the OOD eval punishes a docstring-only corpus on.

    Same hygiene as :func:`package_texts`: paragraphs matching any
    held-out OOD-eval paragraph are dropped, exact duplicates (license
    boilerplate repeated across packages) collapse via the seen-set, and
    the walk order is deterministic (sorted roots, sorted files)."""
    import gzip
    import sysconfig

    roots = [sysconfig.get_paths()["purelib"], *_DOC_FILE_ROOTS]
    forbidden = set(stdlib_heldout_texts())
    texts: list[str] = []
    seen: set[str] = set()
    for root in roots:
        if not os.path.isdir(root):
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(
                d for d in dirnames if d not in ("tests", "test",
                                                 "__pycache__")
            )
            for name in sorted(filenames):
                path = os.path.join(dirpath, name)
                base = name[:-3] if name.endswith(".gz") else name
                if root in _DOC_FILE_ROOTS:
                    ok = base.lower().startswith(
                        ("readme", "news", "changelog", "copyright")
                    ) or base.endswith((".md", ".rst", ".txt"))
                else:
                    ok = base.endswith((".md", ".rst", ".txt"))
                if not ok:
                    continue
                try:
                    if name.endswith(".gz"):
                        with gzip.open(path, "rt", encoding="utf-8",
                                       errors="ignore") as f:
                            raw = f.read(1 << 22)
                    else:
                        with open(path, encoding="utf-8",
                                  errors="ignore") as f:
                            raw = f.read(1 << 22)
                except OSError:
                    continue
                for t in _prose_paragraphs(raw, min_len):
                    if t in forbidden or t in seen:
                        continue
                    seen.add(t)
                    texts.append(t)
                    if len(texts) >= max_texts:
                        return texts
    return texts


def _docstrings_under(root: str, min_len: int, cap: int) -> list[str]:
    """Docstring paragraphs from every ``*.py`` under ``root`` (sorted walk,
    tests/__pycache__ pruned), cleaned to single-space paragraphs."""
    texts: list[str] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(
            d for d in dirnames if d not in ("tests", "test", "__pycache__")
        )
        for name in sorted(filenames):
            if not name.endswith(".py"):
                continue
            try:
                with open(
                    os.path.join(dirpath, name), encoding="utf-8",
                    errors="ignore",
                ) as f:
                    tree = ast.parse(f.read())
            except (OSError, SyntaxError, ValueError):
                continue
            for node in ast.walk(tree):
                if isinstance(
                    node,
                    (ast.Module, ast.FunctionDef, ast.AsyncFunctionDef,
                     ast.ClassDef),
                ):
                    doc = ast.get_docstring(node)
                    if doc:
                        cleaned = " ".join(doc.split())
                        if len(cleaned) >= min_len:
                            texts.append(cleaned)
                            if len(texts) >= cap:
                                return texts
    return texts


def package_texts(
    packages: tuple[str, ...] = PACKAGE_PROSE_ROOTS,
    max_texts: int = 60000,
    min_len: int = 60,
    with_source: bool = False,
) -> list:
    """Natural-English docstring paragraphs mined from installed third-party
    packages: local text, no download, many times the stdlib's supply of
    natural-prose span pairs.

    Hygiene: paragraphs exactly matching any held-out stdlib-subpackage
    paragraph (the OOD eval text source, :func:`stdlib_heldout_texts`) are
    dropped, so a vendored stdlib copy can never leak eval text into
    training. Deterministic order (sorted packages, sorted walk)."""
    import sysconfig

    site = sysconfig.get_paths()["purelib"]
    forbidden = set(stdlib_heldout_texts())
    texts: list[str] = []
    seen: set[str] = set()
    for pkg in packages:
        root = os.path.join(site, pkg)
        if not os.path.isdir(root):
            continue
        for t in _docstrings_under(root, min_len, cap=max_texts):
            if t in forbidden or t in seen:
                continue
            seen.add(t)
            # with_source tags each paragraph with its package name so the
            # trainer can build SAME-PACKAGE batches (hard in-batch
            # negatives: lexically-adjacent API prose)
            texts.append((pkg, t) if with_source else t)
            if len(texts) >= max_texts:
                return texts
    return texts


def span_pairs(
    texts: list[str],
    max_pairs: int,
    seed: int = 0,
    crops_per_text: int = 2,
    min_half_len: int = 40,
) -> list[tuple[str, str]]:
    """Random disjoint sentence-run crop pairs — the generalized form of
    :func:`stdlib_span_pairs` (which always splits at the midpoint). Each
    multi-sentence text contributes up to ``crops_per_text`` pairs with a
    RANDOM split point and random side order, so long docstrings yield
    diverse (query, document) croppings instead of one fixed pair."""
    rng = np.random.default_rng(seed)
    pairs: list[tuple[str, str]] = []
    for text in texts:
        sentences = _SENTENCE_RE.findall(text)
        if len(sentences) < 2:
            continue
        for _ in range(crops_per_text):
            split = int(rng.integers(1, len(sentences)))
            a = " ".join(sentences[:split])
            b = " ".join(sentences[split:])
            if len(a) < min_half_len or len(b) < min_half_len:
                continue
            pairs.append((a, b) if rng.random() < 0.5 else (b, a))
            if len(pairs) >= max_pairs:
                return pairs
    return pairs


def retrieval_eval_ceiling(
    num_docs: int = 1000, num_queries: int = 200, seed: int = 777,
    pool: dict | None = None,
) -> dict:
    """Expected recall ceiling of the eval for a PERFECT concept retriever.

    Two-concept queries typically tie ~11 documents exactly (same concept
    pair + type), so even an oracle that understands every surface
    perfectly cannot always place the one labeled target in the top-10
    under score ties. Returns the expected recall@k under random tie order
    — the honest ceiling against which encoder evals should be read (the
    shipped encoder's 0.85 sits at this ceiling, not below it).
    """
    pool = CONCEPTS if pool is None else pool
    docs, doc_concepts, doc_surfaces, doc_types = concept_corpus(
        num_docs=num_docs, seed=seed, pool=pool
    )
    rng = np.random.default_rng(seed + 1)
    exp = {1: 0.0, 10: 0.0}
    for _ in range(num_queries):
        di = int(rng.integers(0, len(docs)))
        q = paraphrase_query2(
            doc_concepts[di], doc_surfaces[di], rng, doc_types[di], pool
        )
        ql = q.lower()
        mentioned = [
            key
            for key, surfaces in pool.items()
            if any(s.lower() in ql for s in surfaces)
        ]
        # word-boundary match: substrings inside concept surfaces (e.g.
        # 'light' in 'lightning') must not count as a type mention
        has_type = re.search(rf"\b{doc_types[di]}\b", q) is not None
        scores = np.zeros(len(docs))
        for j in range(len(docs)):
            scores[j] = sum(c in doc_concepts[j] for c in mentioned)
            if has_type and doc_types[j] == doc_types[di]:
                scores[j] += 0.5
        better = int((scores > scores[di]).sum())
        ties = int((scores == scores[di]).sum())  # includes the target
        for k in exp:
            exp[k] += min(1.0, max(0, k - better) / ties)
    return {f"recall@{k}": v / num_queries for k, v in exp.items()}
