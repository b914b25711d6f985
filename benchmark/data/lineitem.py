"""TPC-H LINEITEM, all sixteen columns, made on a device from a seed.

The money and date columns are a frozen copy of
``gandiva_tpu_torch/entrypoints.py::lineitem`` (lines 384-434) and its
dictionaries (lines 220-228), kept here so that a change to the program
does not move the benchmark's inputs. The order structure, the keys and
l_comment follow TPC-H v3.0.1 §4.2.3 and §4.2.2.10 (dbgen's ``mk_order``,
``mk_sparse``, ``PART_SUPP_BRIDGE`` and ``dbg_text``). It returns plain
tensors and lists: the harness wraps them into the program's columns, and
the reference reads them as they are.
"""
from __future__ import annotations

import itertools

import torch

ORDERDATE_FIRST, ORDERDATE_LAST = 8035, 10440   # 1992-01-01, 1998-08-02
CURRENTDATE = 9298                               # 1995-06-17 (§4.2.2.12)
PARTS_PER_SF, SUPPLIERS_PER_SF = 200_000, 10_000
COMMENT_LENGTHS = (10, 43)                       # L_COMMENT text [10, 43]

# The string columns' dictionaries (TPC-H §4.2.3, §4.2.2.13): the codes
# drawn below index these lists.
DICTIONARIES = {
    "l_returnflag": ["R", "A", "N"],
    "l_linestatus": ["O", "F"],
    "l_shipinstruct": ["DELIVER IN PERSON", "COLLECT COD", "NONE",
                       "TAKE BACK RETURN"],
    "l_shipmode": ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"],
}
KEY_COLUMNS = ("l_orderkey", "l_partkey", "l_suppkey")
MONEY_COLUMNS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")
DATE_COLUMNS = ("l_shipdate", "l_commitdate", "l_receiptdate")

# The text grammar's word lists (§4.2.2.10; dbgen's dists.dss).
WORDS = {
    "noun": "foxes ideas theodolites pinto_beans instructions dependencies "
            "excuses platelets asymptotes courts dolphins multipliers "
            "sauternes warthogs frets dinos attainments somas Tiresias "
            "patterns forges braids hockey_players frays warhorses dugouts "
            "notornis epitaphs pearls tithes waters orbits gifts sheaves "
            "depths sentiments decoys realms pains grouches escapades",
    "verb": "sleep wake are cajole haggle nag use boost affix detect "
            "integrate maintain nod was lose sublate solve thrash promise "
            "engage hinder print x-ray breach eat grow impress mold poach "
            "serve run dazzle snooze doze unwind kindle play hang believe "
            "doubt",
    "adjective": "furious sly careful blithe quick fluffy slow quiet "
                 "ruthless thin close dogged daring brave stealthy "
                 "permanent enticing idle busy regular final ironic even "
                 "bold silent",
    "adverb": "sometimes always never furiously slyly carefully blithely "
              "quickly fluffily slowly quietly ruthlessly thinly closely "
              "doggedly daringly bravely stealthily permanently enticingly "
              "idly busily regularly finally ironically evenly boldly "
              "silently",
    "preposition": "about above according_to across after against along "
                   "alongside_of among around at atop before behind "
                   "beneath beside besides between beyond by despite during "
                   "except for from in_place_of inside instead_of into near "
                   "of on outside over past since through throughout to "
                   "toward under until up upon without with within",
    "auxiliary": "do may might shall will would can could should ought_to "
                 "must will_have_to shall_have_to could_have_to "
                 "should_have_to must_have_to need_to try_to",
}
TERMINATORS = [".", ";", ":", "?", "!", "--"]
NOUN_PHRASES = [("noun",), ("adjective", "noun"),
                ("adjective", ",", "adjective", "noun"),
                ("adverb", "adjective", "noun")]
VERB_PHRASES = [("verb",), ("auxiliary", "verb"), ("verb", "adverb"),
                ("auxiliary", "verb", "adverb")]
SENTENCES = [("NP", "VP"), ("NP", "VP", "PP"), ("NP", "VP", "NP"),
             ("NP", "PP", "VP", "NP"), ("NP", "PP", "VP", "PP")]


def sparse_key(i: torch.Tensor) -> torch.Tensor:
    """dbgen's ``mk_sparse``: of every 32 order keys the first 8 are used
    (order numbers 1..7 → keys 1..7, 8 → 32, ...)."""
    return ((i >> 3) << 5) + (i & 7)


def line_counts(orders: int, lines: int, g, device) -> torch.Tensor:
    """Each order's number of lines (§4.2.3: uniform 1..7), as one fixed
    multiset that sums to ``lines`` in an order drawn from ``g``: every
    seed makes the same work. The multiset is 1 + (i mod 7) over the
    orders, with the fewest orders moved between 1 and 7 lines (and one
    by less) that make the sum ``lines``."""
    counts = torch.arange(orders, device=device) % 7 + 1
    excess = int(counts.sum()) - lines
    big, small = (7, 1) if excess > 0 else (1, 7)
    moves, rest = divmod(abs(excess), 6)
    at = torch.nonzero(counts == big).flatten()
    if moves + (rest > 0) > at.numel():
        raise ValueError(f"{lines} lines do not fit {orders} orders")
    counts[at[:moves]] = small
    if rest:
        counts[at[moves]] = big - rest if excess > 0 else big + rest
    return counts[torch.randperm(orders, generator=g, device=device)]


def money(n: int, g, device) -> dict:
    """The per-line money draws of §4.2.3, in cents (DECIMAL(15,2)
    unscaled): l_quantity uniform 1..50; l_partkey uniform 1..SF·200,000
    (SF 10); l_extendedprice = l_quantity × p_retailprice, p_retailprice
    = (90000 + ((pk/10) mod 20001) + 100·(pk mod 1000))/100; l_discount
    uniform 0.00..0.10; l_tax uniform 0.00..0.08."""
    def uniform(lo, hi):
        return torch.randint(lo, hi + 1, (n,), generator=g,
                             dtype=torch.int64, device=device)

    qty = uniform(1, 50)
    pk = uniform(1, 10 * PARTS_PER_SF)
    retail = 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)   # cents
    return {"l_partkey": pk, "l_quantity": qty * 100,
            "l_extendedprice": qty * retail,
            "l_discount": uniform(0, 10), "l_tax": uniform(0, 8)}


def order_total(m: dict) -> torch.Tensor:
    """Each line's share of o_totalprice, in cents, as dbgen's
    ``mk_order`` sums it: ((eprice·(100 − disc))/100)·(100 + tax)/100,
    truncating, with disc and tax in hundredths."""
    return ((m["l_extendedprice"] * (100 - m["l_discount"])) // 100
            * (100 + m["l_tax"]) // 100)


def _token_table():
    """The grammar's token strings (a word with its leading space, or a
    comma or terminator with none) and each word class's range of them."""
    tokens, ranges = [], {}
    for cls, words in WORDS.items():
        ranges[cls] = (len(tokens), len(tokens) + len(words.split()))
        tokens += [" " + w.replace("_", " ") for w in words.split()]
    ranges[","] = (len(tokens), len(tokens) + 1)
    tokens.append(",")
    ranges["."] = (len(tokens), len(tokens) + len(TERMINATORS))
    tokens += TERMINATORS
    ranges["the"] = (len(tokens), len(tokens) + 1)
    tokens.append(" the")
    return tokens, ranges


def _templates():
    """Every sentence the grammar makes, as its sequence of token
    classes, with its chance when each choice of the grammar is uniform."""
    out = []
    for form in SENTENCES:
        slots = []
        for part in form:
            if part == "VP":
                slots.append([(v, 1 / len(VERB_PHRASES))
                              for v in VERB_PHRASES])
            else:
                pre = ("preposition", "the") if part == "PP" else ()
                slots.append([(pre + n, 1 / len(NOUN_PHRASES))
                              for n in NOUN_PHRASES])
        for choice in itertools.product(*slots):
            seq = sum((c for c, _ in choice), ()) + (".",)
            p = 1 / len(SENTENCES)
            for _, q in choice:
                p *= q
            out.append((seq, p))
    return out


def text_pool(size: int, g, device) -> torch.Tensor:
    """``size`` bytes of text from the grammar of §4.2.2.10, every choice
    uniform: sentences of noun, verb and prepositional phrases, each word
    drawn from its class's list, as dbgen's ``dbg_text`` pool is made."""
    tokens, ranges = _token_table()
    templates = _templates()
    width = max(len(s) for s, _ in templates)
    classes = list(ranges)
    tmpl = torch.full((len(templates), width), -1, dtype=torch.int64)
    for i, (seq, _) in enumerate(templates):
        tmpl[i, :len(seq)] = torch.tensor([classes.index(c) for c in seq])
    chance = torch.tensor([p for _, p in templates], dtype=torch.float64)
    first = torch.tensor([ranges[c][0] for c in classes])
    many = torch.tensor([ranges[c][1] - ranges[c][0] for c in classes])
    raw = [t.encode() for t in tokens]
    tlen = torch.tensor([len(b) for b in raw])
    tbytes = torch.zeros((len(raw), int(tlen.max())), dtype=torch.uint8)
    for i, b in enumerate(raw):
        tbytes[i, :len(b)] = torch.tensor(list(b), dtype=torch.uint8)
    tmpl, chance, first, many, tlen, tbytes = (
        t.to(device) for t in (tmpl, chance, first, many, tlen, tbytes))
    # ~5 bytes a token at the least: enough sentences to pass ``size``
    sentences = size // (5 * width) + 1
    while True:
        pick = torch.multinomial(chance, sentences, replacement=True,
                                 generator=g)
        cls = tmpl[pick].flatten()
        cls = cls[cls >= 0]
        u = torch.rand(cls.numel(), generator=g, device=device,
                       dtype=torch.float64)
        tok = first[cls] + (u * many[cls]).long().clamp(max=many[cls] - 1)
        lens = tlen[tok]
        if int(lens.sum()) >= size:
            break
        sentences *= 2
    return _substrings(tbytes.flatten(), tok * tbytes.shape[1], lens, size)


HASH_PRIME = 2**31 - 1
HASH_BASES = (1_000_003, 911_382_323)


def _powers(base: int, n: int, device) -> torch.Tensor:
    """base**j mod HASH_PRIME for j in [0, n), by squaring."""
    j = torch.arange(n, device=device)
    out = torch.ones(n, dtype=torch.int64, device=device)
    b, bit = base, 0
    while (1 << bit) < n:
        out = torch.where((j >> bit) & 1 == 1, out * b % HASH_PRIME, out)
        b, bit = b * b % HASH_PRIME, bit + 1
    return out


def _substring_hash(pool: torch.Tensor, start: torch.Tensor,
                    lens: torch.Tensor) -> torch.Tensor:
    """A 62-bit hash of each substring ``pool[start:start + lens]``: two
    polynomial hashes modulo 2**31 - 1, each from prefix sums of the
    pool's bytes times the base's powers, shifted back to position 0."""
    n = pool.numel()
    key = torch.zeros_like(start)
    for base in HASH_BASES:
        pw = _powers(base, n, pool.device)
        prefix = torch.zeros(n + 1, dtype=torch.int64, device=pool.device)
        prefix[1:] = torch.cumsum(pool.long() * pw, 0)
        del pw
        back = _powers(pow(base, HASH_PRIME - 2, HASH_PRIME), n,
                       pool.device)
        h = (prefix[start + lens] - prefix[start]) % HASH_PRIME
        key = (key << 31) | (h * back[start] % HASH_PRIME)
        del prefix, back
    return key


def comments(n: int, pool: torch.Tensor, g):
    """l_comment for ``n`` lines: each a substring of ``pool`` at an
    offset uniform over it, of a length uniform in [10, 43] (§4.2.2.10's
    text string [min, max]). Returned as the program holds a string
    column: int32 codes on the pool's device into a dictionary of the
    distinct values (told apart by ``_substring_hash``), the dictionary
    in Arrow's string layout on the host (int32 offsets, bytes)."""
    device = pool.device
    lo, hi = COMMENT_LENGTHS
    lens = torch.randint(lo, hi + 1, (n,), generator=g, device=device)
    start = (torch.rand(n, generator=g, device=device, dtype=torch.float64)
             * (pool.numel() - lens + 1)).long()
    distinct, codes = torch.unique(_substring_hash(pool, start, lens),
                                   return_inverse=True)
    first = torch.full((distinct.numel(),), n, dtype=torch.int64,
                       device=device)
    first.scatter_reduce_(0, codes, torch.arange(n, device=device), "amin")
    del distinct
    dlens = lens[first]
    offsets = torch.zeros(first.numel() + 1, dtype=torch.int64,
                          device=device)
    offsets[1:] = torch.cumsum(dlens, 0)
    data = _substrings(pool, start[first], dlens)
    return (codes.to(torch.int32), offsets.to(torch.int32).cpu().numpy(),
            data.cpu().numpy())


def _substrings(pool: torch.Tensor, start: torch.Tensor,
                lens: torch.Tensor, size: int = None) -> torch.Tensor:
    """The concatenation of ``pool[start[i]:start[i] + lens[i]]``, cut to
    ``size`` bytes."""
    ends = torch.cumsum(lens, 0)
    pos = torch.arange(int(ends[-1]) if size is None else size,
                       device=pool.device)
    which = torch.searchsorted(ends, pos, right=True)
    return pool[start[which] + pos - (ends - lens)[which]]


def lineitem(n: int, orders: int, seed: int, device,
             pool_bytes: int) -> dict:
    """``n`` lines of ``orders`` orders with the distributions of TPC-H
    §4.2.3. Orders 1..``orders`` in turn, each with its lines (a count
    of ``line_counts``), as dbgen writes them: l_orderkey the order's
    sparse key, l_linenumber 1..count; o_orderdate uniform in
    [1992-01-01, 1998-08-02], one an order; the money of ``money``;
    l_suppkey = (pk + i·(S/4 + (pk − 1)/S)) mod S + 1, i uniform 0..3, S =
    SF·10,000; l_shipdate = o_orderdate + uniform 1..121 days;
    l_commitdate = o_orderdate + uniform 30..90; l_receiptdate =
    l_shipdate + uniform 1..30; l_returnflag 'R' or 'A' at random if
    l_receiptdate <= CURRENTDATE, else 'N'; l_linestatus 'O' if
    l_shipdate > CURRENTDATE, else 'F'; l_shipinstruct and l_shipmode
    uniform over their lists; l_comment of ``comments`` over a text pool
    of ``pool_bytes``. Not null.

    Returns {name: tensor}: the keys as int64, l_linenumber as int32, the
    money columns as int64 cents (DECIMAL(15,2) unscaled), the dates as
    int32 days since 1970-01-01, the dictionary columns as int32 codes
    into ``DICTIONARIES``; and "l_comment" as ``comments`` returns it
    (codes, and its dictionary's offsets and bytes on the host)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def uniform(lo, hi, k=n):
        return torch.randint(lo, hi + 1, (k,), generator=g,
                             dtype=torch.int64, device=device)

    count = line_counts(orders, n, g, device)
    order_of = torch.repeat_interleave(
        torch.arange(orders, device=device), count)
    first_line = torch.cumsum(count, 0) - count
    cols = {"l_orderkey": sparse_key(order_of + 1),
            "l_linenumber": (torch.arange(n, device=device)
                             - first_line[order_of] + 1).to(torch.int32)}
    del first_line
    cols.update(money(n, g, device))
    s = 10 * SUPPLIERS_PER_SF
    pk = cols["l_partkey"]
    cols["l_suppkey"] = (pk + uniform(0, 3) * (s // 4 + (pk - 1) // s)) \
        % s + 1
    del pk
    order = uniform(ORDERDATE_FIRST, ORDERDATE_LAST, orders)[order_of]
    del order_of
    ship = order + uniform(1, 121)
    commit = (order + uniform(30, 90)).to(torch.int32)
    del order
    receipt = ship + uniform(1, 30)
    codes = {
        "l_returnflag": torch.where(receipt <= CURRENTDATE, uniform(0, 1),
                                    2),
        "l_linestatus": (ship <= CURRENTDATE).to(torch.int64),
        "l_shipinstruct": uniform(0, len(DICTIONARIES["l_shipinstruct"]) - 1),
        "l_shipmode": uniform(0, len(DICTIONARIES["l_shipmode"]) - 1)}
    cols["l_shipdate"] = ship.to(torch.int32)
    cols["l_commitdate"] = commit
    cols["l_receiptdate"] = receipt.to(torch.int32)
    del ship, receipt
    for name, c in codes.items():
        cols[name] = c.to(torch.int32)
    cols["l_comment"] = comments(n, text_pool(pool_bytes, g, device), g)
    return cols
