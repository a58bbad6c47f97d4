"""Built-in per-locale stopword lists.

Reference: the `text` analyzer removes locale stopwords loaded from
per-language list files (or an explicit config list,
core/analysis/text_token_stream.cpp:944-971). These
built-ins cover the highest-frequency function words of each supported
snowball locale — overridable per analyzer via the `stopwords` JSON
property (explicit list) or `stopwordsPath` (directory of one-word-per-
line files named by locale, the reference's on-disk format).

Lists are intentionally compact (core articles, prepositions, pronouns,
auxiliaries); production deployments with exacting recall requirements
should ship their own lists via `stopwordsPath`.

A copy of ``iresearch_tpu/analysis/stopwords_data.py``.
"""

from __future__ import annotations

from typing import Dict, FrozenSet

STOPWORDS: Dict[str, FrozenSet[str]] = {
    "en": frozenset(
        """i me my myself we our ours ourselves you your yours yourself
        yourselves he him his himself she her hers herself it its itself
        they them their theirs themselves what which who whom this that
        these those am is are was were be been being have has had having
        do does did doing a an the and but if or because as until while
        of at by for with about against between into through during
        before after above below to from up down in out on off over
        under again further then once here there when where why how all
        any both each few more most other some such no nor not only own
        same so than too very s t can will just don should now""".split()
    ),
    "de": frozenset(
        """aber alle allem allen aller alles als also am an ander andere
        anderem anderen anderer anderes anderm andern anderr anders auch
        auf aus bei bin bis bist da damit dann der den des dem die das
        dass daß derselbe derselben demselben dieselbe dieselben dasselbe
        dazu dein deine deinem deinen deiner deines denn dessen dich dir
        du dies diese diesem diesen dieser dieses doch dort durch ein
        eine einem einen einer eines einig einige einigem einigen einiger
        einiges einmal er ihn ihm es etwas euer eure eurem euren eurer
        eures für gegen gewesen hab habe haben hat hatte hatten hier hin
        hinter ich mich mir ihr ihre ihrem ihren ihrer ihres euch im in
        indem ins ist jede jedem jeden jeder jedes jene jenem jenen jener
        jenes jetzt kann kein keine keinem keinen keiner keines können
        könnte machen man manche manchem manchen mancher manches mein
        meine meinem meinen meiner meines mit muss musste nach nicht
        nichts noch nun nur ob oder ohne sehr sein seine seinem seinen
        seiner seines selbst sich sie sind so solche solchem solchen
        solcher solches soll sollte sondern sonst über um und uns unser
        unsere unserem unseren unserer unseres unter viel vom von vor
        während war waren warst was weg weil weiter welche welchem
        welchen welcher welches wenn werde werden wie wieder will wir
        wird wirst wo wollen wollte würde würden zu zum zur zwar
        zwischen""".split()
    ),
    "fr": frozenset(
        """au aux avec ce ces dans de des du elle en et eux il ils je la
        le les leur lui ma mais me même mes moi mon ne nos notre nous on
        ou par pas pour qu que qui sa se ses son sur ta te tes toi ton tu
        un une vos votre vous c d j l à m n s t y été étée étées étés
        étant étante étants étantes suis es est sommes êtes sont serai
        seras sera serons serez seront serais serait serions seriez
        seraient étais était étions étiez étaient fus fut fûmes fûtes
        furent sois soit soyons soyez soient fusse fusses fût fussions
        fussiez fussent ayant ayante ayantes ayants eu eue eues eus ai as
        avons avez ont aurai auras aura aurons aurez auront aurais aurait
        aurions auriez auraient avais avait avions aviez avaient eut
        eûmes eûtes eurent aie aies ait ayons ayez aient eusse eusses eût
        eussions eussiez eussent""".split()
    ),
    "es": frozenset(
        """de la que el en y a los del se las por un para con no una su
        al lo como más pero sus le ya o este sí porque esta entre cuando
        muy sin sobre también me hasta hay donde quien desde todo nos
        durante todos uno les ni contra otros ese eso ante ellos e esto
        mí antes algunos qué unos yo otro otras otra él tanto esa estos
        mucho quienes nada muchos cual poco ella estar estas algunas algo
        nosotros mi mis tú te ti tu tus ellas nosotras vosotros vosotras
        os mío mía míos mías tuyo tuya tuyos tuyas suyo suya suyos suyas
        nuestro nuestra nuestros nuestras vuestro vuestra vuestros
        vuestras esos esas estoy estás está estamos estáis están ser soy
        eres es somos sois son tengo tienes tiene tenemos tenéis tienen
        fue fueron era eran he has ha hemos habéis han sea sean siendo
        sido haber había habían""".split()
    ),
    "ru": frozenset(
        """и в во не что он на я с со как а то все она так его но да ты
        к у же вы за бы по только ее мне было вот от меня еще нет о из
        ему теперь когда даже ну вдруг ли если уже или ни быть был него
        до вас нибудь опять уж вам ведь там потом себя ничего ей может
        они тут где есть надо ней для мы тебя их чем была сам чтоб без
        будто чего раз тоже себе под будет ж тогда кто этот того потому
        этого какой совсем ним здесь этом один почти мой тем чтобы нее
        сейчас были куда зачем всех никогда можно при наконец два об
        другой хоть после над больше тот через эти нас про всего них
        какая много разве три эту моя впрочем хорошо свою этой перед
        иногда лучше чуть том нельзя такой им более всегда конечно всю
        между это эта эти также он его""".split()
    ),
    "pt": frozenset(
        """de a o que e do da em um para é com não uma os no se na por
        mais as dos como mas foi ao ele das tem à seu sua ou ser quando
        muito há nos já está eu também só pelo pela até isso ela entre
        era depois sem mesmo aos ter seus quem nas me esse eles estão
        você tinha foram essa num nem suas meu às minha têm numa pelos
        elas havia seja qual será nós tenho lhe deles essas esses pelas
        este fosse dele tu te vocês vos lhes meus minhas teu tua teus
        tuas nosso nossa nossos nossas dela delas esta estes estas
        aquele aquela aqueles aquelas isto aquilo estou está estamos
        estão estive esteve estivemos estiveram sou somos são era éramos
        eram fui foi fomos foram seja sejamos sejam serei será seremos
        serão tenho tem temos tinha tínhamos tinham""".split()
    ),
    "it": frozenset(
        """ad al allo ai agli all agl alla alle con col coi da dal dallo
        dai dagli dall dagl dalla dalle di del dello dei degli dell degl
        della delle in nel nello nei negli nell negl nella nelle su sul
        sullo sui sugli sull sugl sulla sulle per tra contro io tu lui
        lei noi voi loro mio mia miei mie tuo tua tuoi tue suo sua suoi
        sue nostro nostra nostri nostre vostro vostra vostri vostre mi
        ti ci vi lo la li le gli ne il un uno una ma ed se perché anche
        come dov dove che chi cui non più quale quanto quanti quanta
        quante quello quelli quella quelle questo questi questa queste
        si tutto tutti a c e i l o ho hai ha abbiamo avete hanno abbia
        abbiate abbiano avrò avrai avrà avremo avrete avranno sono sei è
        siamo siete sia siate siano sarò sarai sarà saremo sarete
        saranno era erano fui fu fummo furono essendo avendo stato stata
        stati state essere avere""".split()
    ),
    "nl": frozenset(
        """de en van ik te dat die in een hij het niet zijn is was op
        aan met als voor had er maar om hem dan zou of wat mijn men dit
        zo door over ze zich bij ook tot je mij uit der daar haar naar
        heb hoe heeft hebben deze u want nog zal me zij nu ge geen omdat
        iets worden toch al waren veel meer doen toen moet ben zonder
        kan hun dus alles onder ja eens hier wie werd altijd doch wordt
        wezen kunnen ons zelf tegen na reeds wil kon niets uw iemand
        geweest andere""".split()
    ),
}


def stopwords_for(locale: str) -> FrozenSet[str]:
    """Built-in stopword set for a locale ('' set when none shipped)."""
    from iresearch_tpu_torch.analysis.snowball import normalize_locale

    return STOPWORDS.get(normalize_locale(locale), frozenset())


def load_stopwords_path(path: str, locale: str) -> FrozenSet[str]:
    """Load `<path>/<locale>` one-word-per-line (the reference's on-disk
    stopword list format); missing file -> built-ins."""
    import os

    from iresearch_tpu_torch.analysis.snowball import normalize_locale

    lang2 = normalize_locale(locale)
    f = os.path.join(path, lang2)
    if not os.path.isfile(f):
        return stopwords_for(locale)
    with open(f, "r", encoding="utf-8") as fh:
        return frozenset(
            w.strip() for w in fh if w.strip() and not w.startswith("#")
        )
