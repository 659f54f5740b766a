"""Synthetic federated LM data.

A copy of ``repro/data/synthetic.py`` (numpy only), so the port draws
bit-identical batches from the same seed.  The paper's datasets (Alpaca,
GSM8K, GLUE) are not available offline; this is a structured synthetic
language whose next-token distribution is *learnable* (so convergence
curves are meaningful) and which supports IID and Dirichlet non-IID client
partitions over "topic" mixtures.

The JAX package's ``DeviceFederatedData`` (batches drawn with
``jax.random`` inside the scan) is not yet ported.
"""
from __future__ import annotations

import json

import numpy as np


class SyntheticLM:
    """Markov-ish token source: K latent topics, each a sparse bigram table."""

    def __init__(self, vocab_size: int, num_topics: int = 8, seed: int = 0,
                 branch: int = 2, noise: float = 0.05):
        rng = np.random.default_rng(seed)
        self.vocab = vocab_size
        self.num_topics = num_topics
        # per-topic: each token deterministically prefers `branch` successors
        self.succ = rng.integers(0, vocab_size,
                                 size=(num_topics, vocab_size, branch))
        self.noise = noise

    def sample(self, rng, topic: int, batch: int, seq_len: int):
        toks = np.empty((batch, seq_len), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=batch)
        succ = self.succ[topic]
        for t in range(1, seq_len):
            choice = rng.integers(0, succ.shape[1], size=batch)
            nxt = succ[toks[:, t - 1], choice]
            noise = rng.random(batch) < self.noise
            nxt = np.where(noise, rng.integers(0, self.vocab, size=batch), nxt)
            toks[:, t] = nxt
        return toks


def client_topic_mixtures(num_clients: int, num_topics: int, *,
                          partition: str = "iid", dirichlet_alpha: float = 0.5,
                          seed: int = 0):
    """Per-client categorical over topics: uniform (IID) or Dir(alpha)."""
    rng = np.random.default_rng(seed)
    if partition == "iid":
        return np.full((num_clients, num_topics), 1.0 / num_topics)
    if partition == "dirichlet":
        return rng.dirichlet(np.full(num_topics, dirichlet_alpha),
                             size=num_clients)
    raise ValueError(partition)


def client_example_counts(num_clients: int, *, total: int = 0,
                          partition: str = "iid",
                          dirichlet_alpha: float = 0.5, seed: int = 0):
    """Per-client example counts n_i (each >= 1, summing to ``total``).

    IID splits the pool evenly; the Dirichlet partition draws client
    proportions ~ Dir(alpha) — small alpha gives the heavy-tailed client
    sizes the paper's heterogeneity experiments vary — and realizes them as
    a multinomial so the counts are integers that sum exactly to ``total``.
    These drive size-weighted aggregation (``FederatedConfig.
    weight_by_size``), where client i's weight in the server mean is
    n_i / sum_j n_j.
    """
    total = int(total) or 512 * num_clients
    if total < num_clients:
        raise ValueError(
            f"total={total} examples cannot give {num_clients} clients "
            ">= 1 example each")
    if partition == "iid":
        base = total // num_clients
        counts = np.full(num_clients, base, np.int64)
        counts[: total - base * num_clients] += 1
        return counts
    if partition == "dirichlet":
        # offset the seed so sizes are not correlated with topic mixtures
        rng = np.random.default_rng(seed + 4242)
        p = rng.dirichlet(np.full(num_clients, dirichlet_alpha))
        return rng.multinomial(total - num_clients, p) + 1
    raise ValueError(partition)


class FederatedDataset:
    """Per-client infinite batch iterator over the synthetic LM."""

    def __init__(self, vocab_size: int, num_clients: int, *, seq_len: int,
                 batch_per_client: int, partition: str = "iid",
                 dirichlet_alpha: float = 0.5, seed: int = 0,
                 num_topics: int = 8, total_examples: int = 0):
        self.lm = SyntheticLM(vocab_size, num_topics, seed=seed)
        self.mix = client_topic_mixtures(num_clients, num_topics,
                                         partition=partition,
                                         dirichlet_alpha=dirichlet_alpha,
                                         seed=seed)
        self.sizes = client_example_counts(num_clients, total=total_examples,
                                           partition=partition,
                                           dirichlet_alpha=dirichlet_alpha,
                                           seed=seed)
        self.num_clients = num_clients
        self.seq_len = seq_len
        self.batch = batch_per_client
        self.rngs = [np.random.default_rng(seed + 1000 + i)
                     for i in range(num_clients)]

    @property
    def size_weights(self):
        """(N,) float: each client's share of the example pool — the
        weights size-weighted aggregation uses in the server mean."""
        return self.sizes / self.sizes.sum()

    def client_batch(self, i: int):
        rng = self.rngs[i]
        topic = rng.choice(self.lm.num_topics, p=self.mix[i])
        return self.lm.sample(rng, topic, self.batch, self.seq_len)

    def round_batch(self, local_steps: int = 1):
        """(num_clients, local_steps, batch, seq) for one federated round."""
        out = np.stack([
            np.stack([self.client_batch(i) for _ in range(local_steps)])
            for i in range(self.num_clients)])
        return out

    def eval_batch(self, batch: int, seed: int = 9999):
        """Held-out IID batch (uniform topic mixture)."""
        rng = np.random.default_rng(seed)
        per = max(1, batch // self.lm.num_topics)
        parts = [self.lm.sample(rng, t, per, self.seq_len)
                 for t in range(self.lm.num_topics)]
        return np.concatenate(parts)[:batch]

    # ---- stream-state (de)serialization, for bit-exact checkpoint resume

    def rng_state(self) -> str:
        """Serialized per-client generator states (JSON)."""
        return json.dumps([r.bit_generator.state for r in self.rngs])

    def set_rng_state(self, state: str) -> None:
        for rng, st in zip(self.rngs, json.loads(state)):
            rng.bit_generator.state = st

    def _lm_fingerprint(self) -> str:
        """Digest of the seed-derived LM transition tables: the partition
        can be restored from a checkpoint, the tables cannot — a mismatch
        means the restoring process built the dataset from a different
        seed and the data stream would silently diverge."""
        import hashlib
        return hashlib.sha1(
            np.ascontiguousarray(self.lm.succ).tobytes()).hexdigest()[:16]

    def partition_state(self) -> str:
        """Serialized client partition (topic mixtures + example counts,
        plus the LM-table fingerprint) — checkpointed so a restored run
        provably resumes under the same clients even if the dataset was
        reconstructed differently."""
        return json.dumps({"mix": self.mix.tolist(),
                           "sizes": self.sizes.tolist(),
                           "lm": self._lm_fingerprint()})

    def set_partition_state(self, state: str) -> None:
        st = json.loads(state)
        if "lm" in st and st["lm"] != self._lm_fingerprint():
            raise ValueError(
                "checkpoint was written against a dataset with different "
                "LM transition tables (different seed/vocab/topics) — "
                "reconstruct the FederatedDataset with the original "
                "parameters to resume bit-exactly")
        mix = np.asarray(st["mix"], np.float64)
        sizes = np.asarray(st["sizes"], np.int64)
        if mix.shape != self.mix.shape:
            raise ValueError(
                f"checkpoint partition has {mix.shape[0]} clients x "
                f"{mix.shape[1]} topics; this dataset has "
                f"{self.mix.shape[0]} x {self.mix.shape[1]}")
        self.mix = mix
        self.sizes = sizes
